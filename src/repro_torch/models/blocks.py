"""Non-attention blocks of the port: the dense FFN (gated and ungated), the
RG-LRU recurrent block (Griffin / RecurrentGemma) and the Mamba-2 SSD mixer,
the counterparts of ``repro.models.blocks``. The MoE blocks are not ported
yet.

With ``cfg.use_pallas`` the two scans run the hand-written Hopper kernels
of ``repro_torch.kernels`` (on a CPU tensor, their plain versions). The
fp32 gate products of the RG-LRU block are full fp32 matrix products:
PyTorch's default keeps TF32 off for them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, dense_init, ffn_act,
                                       is_gated, rms_norm)


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

def init_ffn(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None):
    d_ff = d_ff or cfg.d_ff
    dt = cfg.weight_dtype
    p = {"w_in": dense_init(gen, (cfg.d_model, d_ff), dt),
         "w_out": dense_init(gen, (d_ff, cfg.d_model), dt)}
    if is_gated(cfg.ffn_activation):
        p["w_gate"] = dense_init(gen, (cfg.d_model, d_ff), dt)
    return p


def ffn_forward(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_in"].to(x.dtype)
    if is_gated(cfg.ffn_activation):
        gate = x @ p["w_gate"].to(x.dtype)
        h = ffn_act(gate, up, cfg.ffn_activation)
    else:
        h = ffn_act(up, up, cfg.ffn_activation)
    return h @ p["w_out"].to(x.dtype)


# ---------------------------------------------------------------------------
# Shared: depthwise causal conv
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv along seq. x (B,S,W), w (k,W), tail (B,k-1,W).
    Returns (out (B,S,W), new_tail (B,k-1,W))."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)                       # (B,S+k-1,W)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i][None, None] for i in range(k))
    new_tail = xp[:, -(k - 1):] if k > 1 else tail
    return out, new_tail


# ---------------------------------------------------------------------------
# RG-LRU (Real-Gated Linear Recurrent Unit): RecurrentGemma / Griffin
# ---------------------------------------------------------------------------

class RGLRUState(NamedTuple):
    h: torch.Tensor         # (B, lru_width) recurrent state, fp32
    conv: torch.Tensor      # (B, k-1, lru_width) conv tail


_LRU_C = 8.0  # Griffin's c constant


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig):
    dt = cfg.weight_dtype
    W = cfg.lru_width
    lam = 0.9 + 0.099 * torch.rand((W,), generator=gen, device=gen.device,
                                   dtype=torch.float32)
    return {
        "w_x": dense_init(gen, (cfg.d_model, W), dt),
        "w_y": dense_init(gen, (cfg.d_model, W), dt),  # multiplicative branch
        "conv_w": dense_init(gen, (cfg.conv_kernel, W), dt, scale=0.5),
        "lambda_param": lam,
        "w_input_gate": dense_init(gen, (W, W), dt, scale=0.02),
        "w_rec_gate": dense_init(gen, (W, W), dt, scale=0.02),
        "w_out": dense_init(gen, (W, cfg.d_model), dt),
    }


def _lru_log_a(p, gate_r: torch.Tensor) -> torch.Tensor:
    """log recurrence coefficient: -c * softplus(Lambda) * sigmoid(r)."""
    softp = F.softplus(p["lambda_param"])                 # (W,)
    return -_LRU_C * softp * gate_r                        # (..., W)


def rglru_scan(x: torch.Tensor, log_a: torch.Tensor, h0: torch.Tensor,
               use_pallas: bool = False):
    """Linear recurrence h_t = a_t h_{t-1} + sqrt(1-a_t^2) x_t over the seq
    axis. x, log_a: (B,S,W) fp32; h0: (B,W). Returns (ys (B,S,W), h_last).
    The plain path is the kernel's plain version, which walks time token by
    token (the JAX package's associative scan sums in another order)."""
    if use_pallas:
        from repro_torch.kernels import ops as kops
        return kops.rglru_scan(x, log_a, h0)
    from repro_torch.kernels.ref import rglru_scan as rglru_scan_plain
    return rglru_scan_plain(x, log_a, h0)


def rglru_block_forward(p, cfg: ModelConfig, x: torch.Tensor,
                        state: Optional[RGLRUState] = None
                        ) -> Tuple[torch.Tensor, RGLRUState]:
    """Full Griffin recurrent block: in-proj -> conv -> RG-LRU -> gate ->
    out. x: (B,S,d_model). Works for S==1 (decode) given a state."""
    B, S, _ = x.shape
    W = cfg.lru_width
    xb = x @ p["w_x"].to(x.dtype)                          # (B,S,W)
    yb = F.gelu((x @ p["w_y"].to(x.dtype)).float(), approximate="tanh")
    tail = state.conv if state is not None else None
    xc, new_tail = _causal_conv(xb, p["conv_w"].to(xb.dtype), tail)
    xc32 = xc.float()
    gate_i = torch.sigmoid(xc32 @ p["w_input_gate"].float())
    gate_r = torch.sigmoid(xc32 @ p["w_rec_gate"].float())
    log_a = _lru_log_a(p, gate_r)                          # (B,S,W)
    gated_x = gate_i * xc32
    h0 = (state.h if state is not None
          else torch.zeros((B, W), dtype=torch.float32, device=x.device))
    if S == 1:
        a = torch.exp(log_a[:, 0])
        h = a * h0 + torch.sqrt(torch.clamp(1 - a * a, 1e-9, 1)) * \
            gated_x[:, 0]
        ys = h[:, None]
        h_last = h
    else:
        ys, h_last = rglru_scan(gated_x, log_a, h0,
                                use_pallas=cfg.use_pallas)
    out = (ys * yb).to(x.dtype)                            # multiplicative gate
    y = out @ p["w_out"].to(x.dtype)
    return y, RGLRUState(h=h_last, conv=new_tail)


def init_rglru_state(cfg: ModelConfig, batch: int,
                     device="cuda") -> RGLRUState:
    return RGLRUState(
        h=torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, cfg.conv_kernel - 1, cfg.lru_width),
                         dtype=cfg.activation_dtype, device=device))


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality) mixer
# ---------------------------------------------------------------------------

class SSDState(NamedTuple):
    ssm: torch.Tensor       # (B, H, P, N) recurrent state, fp32
    conv: torch.Tensor      # (B, k-1, conv_dim) conv tail


def init_ssd_block(gen: torch.Generator, cfg: ModelConfig):
    dt = cfg.weight_dtype
    d_in = cfg.d_inner
    H = cfg.ssm_nheads
    N = cfg.ssm_state
    G = cfg.ssm_ngroups
    conv_dim = d_in + 2 * G * N
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        # fused in-proj: [z (d_in), x (d_in), B (G*N), C (G*N), dt (H)]
        "w_in": dense_init(gen, (cfg.d_model, 2 * d_in + 2 * G * N + H), dt),
        "conv_w": dense_init(gen, (cfg.conv_kernel, conv_dim), dt,
                             scale=0.5),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm_w": torch.ones((d_in,), dtype=dt, device=gen.device),
        "w_out": dense_init(gen, (d_in, cfg.d_model), dt),
    }


def _ssd_split(p, cfg: ModelConfig, u: torch.Tensor):
    d_in = cfg.d_inner
    G, N, H = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    zxbcdt = u @ p["w_in"].to(u.dtype)
    z, xBC, dt = torch.split(zxbcdt, [d_in, d_in + 2 * G * N, H], dim=-1)
    return z, xBC, dt


def ssd_chunked(x, dt, A, B, C, chunk: int, use_pallas: bool = False):
    """Chunked SSD algorithm (Mamba-2 §6): intra-chunk dual (attention-like)
    form + inter-chunk recurrence on states.

    x: (b, s, h, p); dt: (b, s, h); A: (h,); B, C: (b, s, g, n).
    Returns (y (b,s,h,p), final_state (b,h,p,n)). All fp32.
    """
    if use_pallas:
        from repro_torch.kernels import ops as kops
        return kops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    s_orig = s
    if s % chunk:
        # pad with dt=0 positions: decay exp(0)=1, zero state/output
        # contribution, so padding is an exact no-op.
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    rep = h // g
    xr = x.reshape(b, nc, chunk, h, p)
    dtr = dt.reshape(b, nc, chunk, h)
    Br = torch.repeat_interleave(B.reshape(b, nc, chunk, g, n), rep, dim=3)
    Cr = torch.repeat_interleave(C.reshape(b, nc, chunk, g, n), rep, dim=3)
    dA = dtr * A[None, None, None]                          # decay rate > 0
    # cumulative log-decay within chunk
    seg = torch.cumsum(dA, dim=2)                           # (b,nc,c,h)
    # intra-chunk: y_ij = C_i . B_j * exp(seg_i - seg_j) * dt_j  (j<=i)
    li = seg[:, :, :, None]                                 # i axis
    lj = seg[:, :, None, :]                                 # j axis
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    # mask the exponent BEFORE exp, as the JAX package does
    delta = torch.where(mask, li - lj, 0.0)
    decay = torch.where(mask, torch.exp(-delta), 0.0)       # (b,nc,c,c,h)
    cb = torch.einsum("bkihn,bkjhn->bkijh", Cr, Br)
    att = cb * decay * dtr[:, :, None]                      # weight by dt_j
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", att, xr)
    # chunk states: S_k = sum_j exp(seg_last - seg_j) dt_j B_j x_j^T
    last = seg[:, :, -1:, :]                                # (b,nc,1,h)
    w = torch.exp(-(last - seg)) * dtr                      # (b,nc,c,h)
    states = torch.einsum("bkjh,bkjhn,bkjhp->bkhpn", w, Br, xr)
    # inter-chunk recurrence over k: S'_k = exp(-sum dA_k) S'_{k-1} + S_k
    chunk_decay = torch.exp(-torch.sum(dA, dim=2))          # (b,nc,h)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for k in range(nc):                                     # state *before* chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, k, :, None, None] + states[:, k]
    prev_states = torch.stack(prev, dim=1)                  # (b,nc,h,p,n)
    # contribution of the incoming state to each position in the chunk:
    # y_i += exp(-seg_i) * C_i . S_prev
    y_inter = torch.einsum("bkihn,bkhpn,bkih->bkihp", Cr, prev_states,
                           torch.exp(-seg))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    if s != s_orig:
        y = y[:, :s_orig]
    return y, carry


def ssd_block_forward(p, cfg: ModelConfig, u: torch.Tensor,
                      state: Optional[SSDState] = None
                      ) -> Tuple[torch.Tensor, SSDState]:
    """Full Mamba-2 block. u: (B,S,d_model). S==1 with a state: the
    recurrent decode step (plain PyTorch, as in the JAX package)."""
    Bsz, S, _ = u.shape
    d_in = cfg.d_inner
    G, N, H, P = (cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                  cfg.ssm_head_dim)
    z, xBC, dt = _ssd_split(p, cfg, u)
    tail = state.conv if state is not None else None
    xBC, new_tail = _causal_conv(xBC, p["conv_w"].to(xBC.dtype), tail)
    xBC = F.silu(xBC.float())
    x, Bmat, Cmat = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    x = x.reshape(Bsz, S, H, P)
    Bmat = Bmat.reshape(Bsz, S, G, N)
    Cmat = Cmat.reshape(Bsz, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])              # (B,S,H)
    A = torch.exp(p["A_log"])                                # (H,) > 0
    if S == 1 and state is not None:
        # recurrent step: S' = exp(-dt*A) S + dt * B x^T ; y = C.S' + D x
        dA = torch.exp(-dt[:, 0, :, None, None] * A[None, :, None, None])
        rep = H // G
        Bs = torch.repeat_interleave(Bmat[:, 0], rep, dim=1)  # (B,H,N)
        Cs = torch.repeat_interleave(Cmat[:, 0], rep, dim=1)
        upd = dt[:, 0, :, None, None] * torch.einsum(
            "bhn,bhp->bhpn", Bs, x[:, 0])
        new_state = dA * state.ssm + upd
        y = torch.einsum("bhn,bhpn->bhp", Cs, new_state)
        y = y + p["D"][None, :, None] * x[:, 0]
        y = y[:, None]                                       # (B,1,H,P)
        final = new_state
    else:
        # a prefill starts from a zero state, as in the JAX package
        y, final = ssd_chunked(x, dt, A, Bmat, Cmat, cfg.ssm_chunk,
                               use_pallas=cfg.use_pallas)
        y = y + p["D"][None, None, :, None] * x
    y = y.reshape(Bsz, S, d_in)
    # gated RMSNorm (mamba2 style): norm(y * silu(z)), on the plain path
    # with or without the kernels, as in the JAX package
    y = y * F.silu(z.float())
    y = rms_norm(y.to(u.dtype), p["norm_w"], cfg.norm_eps)
    out = y @ p["w_out"].to(u.dtype)
    return out, SSDState(ssm=final, conv=new_tail)


def init_ssd_state(cfg: ModelConfig, batch: int,
                   device="cuda") -> SSDState:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return SSDState(
        ssm=torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                         dtype=cfg.activation_dtype, device=device))
