"""Mamba-2 1.3B as the benchmark runs it: its weights, drawn from the seed
in the program's layout; its plain fp32 reference; and the operations a
decode step needs.

The reference is plain PyTorch and follows the published description
(arXiv:2405.21060) as ``mamba2-1.3b.json`` states it: each layer an
RMSNorm, the fused in-projection to (z, x, B, C, dt), a causal depthwise
conv of width 4 over (x, B, C) and SiLU, the selective state-space
recurrence S_t = exp(-dt_t A) S_{t-1} + dt_t x_t B_t^T, y_t = C_t S_t +
D x_t (per head, dt = softplus(dt + dt_bias), A = exp(A_log)), the gate
y * silu(z), a gated RMSNorm and the out-projection; embeddings tied.
A run's decode steps feed token 0 to every row from a zeroed state, so
every row holds the state of the same sequence of zeros: the reference
computes that one sequence, layer by layer over all its tokens, the
recurrence in its chunked form (chunks of 64), which is the same sum.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from bench import plain

CHUNK = 64

def _mc(cfg: dict) -> dict:
    return cfg["model_config"]


def _sizes(m):
    d_in = m["ssm_expand"] * m["d_model"]
    H = d_in // m["ssm_head_dim"]
    GN = m["ssm_ngroups"] * m["ssm_state"]
    return d_in, H, GN, d_in + 2 * GN


def leaves(cfg: dict):
    m = _mc(cfg)
    d, V = m["d_model"], m["vocab_size"]
    d_in, H, GN, conv = _sizes(m)
    bf, f32 = torch.bfloat16, torch.float32
    # as mamba_ssm initialises the model: nn.Linear's and nn.Conv1d's
    # default spreads, the out-projection into the residual stream scaled
    # by 1/sqrt(layers) (rescale_prenorm_residual), dt between 0.001 and 0.1
    res = m["num_layers"] ** -0.5
    out = [(("embed",), (V, d), bf, ("normal", 0.02)),
           (("final_norm",), (d,), bf, ("around_one", 0.1))]
    for i in range(m["num_layers"]):
        p = ("layers", i)
        out += [(p + ("norm",), (d,), bf, ("around_one", 0.1)),
                (p + ("mixer", "w_in"), (d, 2 * d_in + 2 * GN + H), bf,
                 ("normal", (3 * d) ** -0.5)),
                (p + ("mixer", "conv_w"), (m["conv_kernel"], conv), bf,
                 ("normal", 12 ** -0.5)),
                (p + ("mixer", "A_log"), (H,), f32,
                 ("log_uniform", 1.0, 16.0)),
                (p + ("mixer", "D"), (H,), f32, ("uniform", 0.5, 1.5)),
                (p + ("mixer", "dt_bias"), (H,), f32,
                 ("softplus_inverse_log_uniform", 1e-3, 0.1)),
                (p + ("mixer", "norm_w"), (d_in,), bf, ("around_one", 0.1)),
                (p + ("mixer", "w_out"), (d_in, d), bf,
                 ("normal", res * d_in ** -0.5))]
    return out


def make_weights(cfg: dict, gen: torch.Generator, device, into=None):
    return plain.draw(leaves(cfg), gen, device, into)


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

def _scan(x, dt, A, B, C):
    """The recurrence over T tokens from a zero state, in chunks: x (T, H,
    P), dt (T, H), A (H,), B and C (T, N) (one group) -> y (T, H, P), the
    final state (H, P, N)."""
    T, H, P = x.shape
    N = B.shape[-1]
    pad = (-T) % CHUNK                 # dt = 0: an exact no-op
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    k = x.shape[0] // CHUNK
    x = x.view(k, CHUNK, H, P)
    dt = dt.view(k, CHUNK, H)
    B, C = B.view(k, CHUNK, N), C.view(k, CHUNK, N)
    seg = torch.cumsum(dt * A, dim=1)                           # (k, Q, H)
    tri = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                                device=x.device))
    diff = seg[:, :, None, :] - seg[:, None, :, :]              # (k,i,j,H)
    decay = torch.where(tri[None, :, :, None],
                        torch.exp(-torch.where(tri[None, :, :, None], diff,
                                               0.0)), 0.0)
    cb = torch.einsum("kin,kjn->kij", C, B)
    att = cb[..., None] * decay * dt[:, None, :, :]             # (k,i,j,H)
    y = torch.einsum("kijh,kjhp->kihp", att, x)
    w_end = torch.exp(-(seg[:, -1:, :] - seg)) * dt             # (k, Q, H)
    chunk_state = torch.einsum("kjhp,kjn->khpn", w_end[..., None] * x, B)
    chunk_decay = torch.exp(-seg[:, -1, :])                     # (k, H)
    S = torch.zeros((H, P, N), device=x.device)
    for i in range(k):
        y[i] += (torch.einsum("in,hpn->ihp", C[i], S)
                 * torch.exp(-seg[i])[..., None])
        S = S * chunk_decay[i][:, None, None] + chunk_state[i]
    return y.reshape(k * CHUNK, H, P)[:T], S


def replay(params, cfg: dict, pos: torch.Tensor, *, prec: str = "fp32",
           logits_at: Optional[torch.Tensor] = None,
           on_layer: Optional[Callable] = None, teacher=None,
           rows_per_block: int = 0) -> Dict[str, torch.Tensor]:
    """The decode steps of a run from a zeroed state: ``pos`` (T, R) says
    how many (T); every row is the same sequence, computed once (R = 1).
    Returns the logits (len(logits_at), 1, V) of the steps ``logits_at``
    (default: the last); ``on_layer(i, leaves)`` receives each layer's
    state as the run leaves it, in the program's order: the SSM state (1,
    H, P, N) and the conv's tail (1, k - 1, conv width). ``teacher`` is
    not used: the state forgets (every layer's recurrence decays), so a
    run of the reference on its own stays beside the program's."""
    plain.no_tf32()
    m = _mc(cfg)
    T = pos.shape[0]
    eps = m["norm_eps"]
    d_in, H, GN, conv = _sizes(m)
    P, k = m["ssm_head_dim"], m["conv_kernel"]
    if logits_at is None:
        logits_at = torch.tensor([T - 1], device=pos.device)
    x = params["embed"][0].float().expand(T, -1).clone()
    for i, lp in enumerate(params["layers"]):
        mx = lp["mixer"]
        h = plain.rmsnorm(x, lp["norm"], eps)
        zxbcdt = plain.mm(h, mx["w_in"], prec)
        z, xbc, dt = torch.split(zxbcdt, [d_in, conv, H], dim=-1)
        xpad = torch.cat([xbc.new_zeros(k - 1, conv), xbc])
        w = mx["conv_w"].float()
        cv = sum(xpad[j:j + T] * w[j] for j in range(k))
        xs, Bm, Cm = torch.split(F.silu(cv), [d_in, GN, GN], dim=-1)
        dt = F.softplus(dt + mx["dt_bias"])
        y, S = _scan(xs.view(T, H, P), dt, torch.exp(mx["A_log"]), Bm, Cm)
        y = y + mx["D"][:, None] * xs.view(T, H, P)
        y = y.reshape(T, d_in) * F.silu(z)
        y = plain.rmsnorm(y, mx["norm_w"], eps)
        x = x + plain.mm(y, mx["w_out"], prec)
        if on_layer is not None:
            on_layer(i, [plain.act(S, prec)[None],
                         plain.act(xpad[T:T + k - 1], prec)[None]])
    h = plain.rmsnorm(x[logits_at], params["final_norm"], eps)
    return {"logits": plain.mm(h, params["embed"].t(), prec)[:, None]}


def head(params, cfg: dict) -> torch.Tensor:
    """The output head as the last norm's output meets it: (d, V) fp32,
    the final norm's weight folded in (embeddings tied)."""
    return params["final_norm"].float()[:, None] * params["embed"].float().t()


def program_cache_layers(cache):
    """The program's state per layer, in ``replay``'s order: [ssm (B, H,
    P, N), conv (B, k - 1, conv width)]."""
    for i in range(cache.ssm.shape[0]):
        yield [cache.ssm[i], cache.conv[i]]


# ---------------------------------------------------------------------------
# Operations of one decode step
# ---------------------------------------------------------------------------

def decode_flops(cfg: dict, contexts) -> float:
    """The operations one decode step needs for ``len(contexts)`` rows (a
    state-space layer's work does not grow with the context): the in- and
    out-projections, the conv, the recurrence (5 per state element: decay,
    outer product, add, and C times the state), the gate and the head."""
    m = _mc(cfg)
    d, V = m["d_model"], m["vocab_size"]
    d_in, H, GN, conv = _sizes(m)
    P, N = m["ssm_head_dim"], m["ssm_state"]
    layer = (2 * d * (2 * d_in + 2 * GN + H) + 2 * m["conv_kernel"] * conv
             + 5 * H * P * N + 2 * d_in * d)
    return float((m["num_layers"] * layer + 2 * d * V) * len(contexts))
