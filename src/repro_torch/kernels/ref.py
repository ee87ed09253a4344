"""Plain PyTorch versions of the port's kernels, the counterparts of the
jnp oracles in ``repro.kernels.ref``. They run wherever PyTorch runs: the
wrappers call them for a CPU tensor, and the tests and ``chip_smoke.py``
hold each kernel against them. The two scans walk time token by token, as
the oracles do. ``ssd_step``, Mamba-2's decode step, has no oracle there:
it is the model's own step (``repro.models.blocks.ssd_block_forward`` at
S == 1), and updates the state it is given in place.

One case differs from ``repro.kernels.ref`` on purpose: a decode row with
no valid slot. The Pallas decode kernel zeroes ``p`` where a slot is
invalid and divides by ``l == 0 -> 1``, so such a row gives 0
(``repro/kernels/decode_attention.py``); the jnp oracle's softmax over all
-1e30 is uniform and gives mean(V). Both the port's kernel and this plain
version compute what the TPU kernel computes: 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,S,Hkv,D) -> (B,S,H,D). GQA by head grouping."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float())
    scores = scores * (D ** -0.5)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q: (B,1,H,D); caches (B,T,Hkv,D); valid (B,T) bool -> (B,1,H,D).
    A row with no valid slot gives 0, as the TPU kernel does."""
    B, _, H, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    scores = torch.einsum("bhgd,bthd->bhgt", qg,
                          k_cache.float()) * (D ** -0.5)
    live = valid[:, None, None, :]
    scores = torch.where(live, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    probs = p / torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhgt,bthd->bhgd", probs, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def mla_decode(q: torch.Tensor, c_kv: torch.Tensor, k_rope: torch.Tensor,
               valid: torch.Tensor, scale: float) -> torch.Tensor:
    """MLA decode in the latent space, in fp32: q (B,H,R+RP), each head's
    query taken into the latent space (R) then its rope part (RP); c_kv
    (B,T,R) and k_rope (B,T,RP), one key and value every head shares;
    valid (B,T) bool -> o_lat (B,H,R) in q's dtype. A row with no valid
    slot gives 0."""
    R = c_kv.shape[-1]
    qf = q.float()
    scores = (torch.einsum("bhr,btr->bht", qf[..., :R], c_kv.float())
              + torch.einsum("bhp,btp->bht", qf[..., R:], k_rope.float()))
    live = valid[:, None, :]
    scores = torch.where(live, scores * scale, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    probs = p / torch.where(l == 0.0, 1.0, l)
    return torch.einsum("bht,btr->bhr", probs, c_kv.float()).to(q.dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def add_rmsnorm(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
                *, eps: float = 1e-6):
    """The residual add and the norm after it: (s, rmsnorm(s)), s = x + r."""
    s = x + r
    return s, rmsnorm(s, weight, eps=eps)


def rglru_scan(x: torch.Tensor, log_a: torch.Tensor,
               h0: torch.Tensor):
    """h_t = a_t h_{t-1} + sqrt(1-a_t^2) x_t with a = exp(log_a), walked
    token by token. x, log_a (B,S,W); h0 (B,W) -> (ys (B,S,W), h_last
    (B,W)), fp32."""
    a = torch.exp(log_a.float())
    gated = torch.sqrt(torch.clamp(1.0 - a * a, 1e-9, 1.0)) * x.float()
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + gated[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1), h


def rglru_gated_scan(xc: torch.Tensor, pre_i: torch.Tensor,
                     pre_r: torch.Tensor, lam: torch.Tensor,
                     pre_y: torch.Tensor, h0: torch.Tensor):
    """The recurrent block of ``repro.models.blocks.rglru_block_forward``
    from its three products on, op for op: the input and recurrence gates,
    log a = -8 softplus(lam) sigmoid(pre_r), the scan of gate_i * xc from
    h0, and the output gate gelu_tanh(pre_y). xc, pre_i, pre_r (B,S,W) fp32;
    lam (W,) fp32; pre_y (B,S,W) in the activation dtype; h0 (B,W) fp32 ->
    (out (B,S,W) in pre_y's dtype, h_last (B,W) fp32)."""
    gate_i = torch.sigmoid(pre_i)
    gate_r = torch.sigmoid(pre_r)
    log_a = -8.0 * F.softplus(lam) * gate_r
    ys, h_last = rglru_scan(gate_i * xc, log_a, h0)
    yb = F.gelu(pre_y.float(), approximate="tanh")
    return (ys * yb).to(pre_y.dtype), h_last


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor):
    """Sequential state-space oracle of the SSD kernel, token by token.

    x (b,s,h,p); dt (b,s,h); A (h,); B,C (b,s,g,n).
    Returns (y (b,s,h,p), final_state (b,h,p,n)), fp32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Br = torch.repeat_interleave(B.float(), rep, dim=2)
    Cr = torch.repeat_interleave(C.float(), rep, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(-dtf[:, t] * Af[None])[..., None, None]
        upd = dtf[:, t, :, None, None] * torch.einsum(
            "bhn,bhp->bhpn", Br[:, t], xf[:, t])
        state = decay * state + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", Cr[:, t], state))
    return torch.stack(ys, dim=1), state


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             state: torch.Tensor) -> torch.Tensor:
    """Mamba-2's recurrent decode step, one token, as the model's S == 1
    branch computes it: x (b,h,p); dt (b,h), after the softplus; A (h,),
    exp(A_log); B, C (b,g,n), head i reading group i // (h / g); D (h,);
    state (b,h,p,n) fp32, updated in place to S' = exp(-dt A) S + dt B x^T.
    Returns y = C.S' + D x (b,h,p)."""
    rep = x.shape[1] // B.shape[1]
    dA = torch.exp(-dt[:, :, None, None] * A[None, :, None, None])
    Bs = torch.repeat_interleave(B, rep, dim=1)              # (b,h,n)
    Cs = torch.repeat_interleave(C, rep, dim=1)
    upd = dt[:, :, None, None] * torch.einsum("bhn,bhp->bhpn", Bs, x)
    # dA * S + upd, rounded as the JAX package's functional form
    final = state.mul_(dA).add_(upd)
    y = torch.einsum("bhn,bhpn->bhp", Cs, final)
    return y + D[None, :, None] * x
