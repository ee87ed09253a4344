"""Non-attention blocks of the port: the dense FFN (gated and ungated), MoE
(top-k routed experts plus shared experts, with dense or capacity
dispatch), the RG-LRU recurrent block (Griffin / RecurrentGemma) and the
Mamba-2 SSD mixer, the counterparts of ``repro.models.blocks``.

With ``cfg.use_pallas`` the SSD scan, the SSD decode step and the RG-LRU
block's gates and recurrence run the hand-written Hopper kernels of
``repro_torch.kernels`` (on a CPU tensor, their plain versions). The fp32
gate products of the RG-LRU block are full fp32 matrix products:
PyTorch's default keeps TF32 off for them. Their weights are held in fp32
(``GATES_FP32``): the init draws them in the weight dtype and widens them
once, which is exact, so the products are those of the widened weight in
the JAX package.

Given a state, a block writes its new recurrent state into that state's
tensors and returns it, so a cache keeps its addresses from step to step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, dense_init, ffn_act,
                                       is_dtensor, is_gated, matmul, rms_norm,
                                       uniform_init)


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
    if is_gated(cfg.ffn_activation):
        up, gate = matmul(x, p["w_in"].to(x.dtype), p["w_gate"].to(x.dtype))
        h = ffn_act(gate, up, cfg.ffn_activation)
    else:
        up = matmul(x, p["w_in"].to(x.dtype))
        h = ffn_act(up, up, cfg.ffn_activation)
    return matmul(h, p["w_out"].to(x.dtype))


# ---------------------------------------------------------------------------
# MoE: top-k routed experts (+ optional shared experts)
#
# The JAX package runs the experts on fp32 operands: widened activations and
# widened expert weights. Products of two bf16 values are exact in fp32, so
# on the card ``_mm_f32`` computes the same products with bf16 tensor-core
# GEMMs that accumulate and write fp32, and no fp32 copy of the weights;
# only the sums differ, in order and in the tensor cores' rounding of them.
# Nothing in the routing or the dispatch reads a value on the host or makes
# a shape from the data, so a step captures as a CUDA graph.
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig):
    """The router over ``cfg.routed_experts`` experts (with the sigmoid
    router, its fp32 correction bias ``e_score_correction_bias``, zeros),
    the ``num_experts`` experts held here and the shared experts."""
    dt = cfg.weight_dtype
    E = cfg.num_experts
    d_ff = cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": dense_init(gen, (cfg.d_model, cfg.routed_experts), dt,
                             scale=0.02),
        "w_gate": dense_init(gen, (E, cfg.d_model, d_ff), dt),
        "w_in": dense_init(gen, (E, cfg.d_model, d_ff), dt),
        "w_out": dense_init(gen, (E, d_ff, cfg.d_model), dt),
    }
    if cfg.router_scoring == "sigmoid":
        p["e_score_correction_bias"] = torch.zeros(
            (cfg.routed_experts,), dtype=torch.float32, device=gen.device)
    if cfg.num_shared_experts:
        shared_ff = d_ff * cfg.num_shared_experts
        p["shared"] = init_ffn(gen, cfg.replace(d_ff=shared_ff),
                               d_ff=shared_ff)
    return p


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_entropy: torch.Tensor


def _split_bf16(a: torch.Tensor):
    """Three bf16 tensors whose fp32 sum is ``a`` (fp32): each takes the
    next 8 bits of the 24-bit significand, and each difference is exact."""
    hi = a.to(torch.bfloat16)
    r = a - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.float() @ b.float()`` for (M, K) @ (K, N) or batched
    (E, M, K) @ (E, K, N), in fp32. With bf16 ``b`` on the card: one bf16
    GEMM with an fp32 output over ``a`` (bf16), or over the three bf16
    parts of ``a`` (fp32, ``_split_bf16``) stacked along M and summed after,
    so every product is exact and only the sums differ from the widened
    product's (their order, and the tensor cores' fp32 accumulation).
    Where autograd records the product (a train step), the widened
    product: the GEMM with an fp32 output has no derivative."""
    mm = torch.mm if a.dim() == 2 else torch.bmm
    records = torch.is_grad_enabled() and (a.requires_grad
                                           or b.requires_grad)
    if records or not (b.is_cuda and b.dtype == torch.bfloat16):
        return mm(a.float(), b.float())
    if a.dtype == torch.bfloat16:
        return mm(a, b, out_dtype=torch.float32)
    M = a.shape[-2]
    out = mm(torch.cat(_split_bf16(a.float()), dim=-2), b,
             out_dtype=torch.float32)
    return out[..., :M, :] + out[..., M:2 * M, :] + out[..., 2 * M:, :]


def route(p, cfg: ModelConfig, x: torch.Tensor):
    """The router's probabilities (B,S,E) fp32 and each token's top-k
    weights (renormalised) and experts (B,S,K). Among equal probabilities
    the lower expert comes first, as ``jax.lax.top_k`` takes them: a stable
    descending sort, cut to K. No caller draws the router's jitter (the
    JAX package's models pass no key for it either). ``router_scoring``
    "sigmoid" routes as DeepSeek-V3 does (``_route_sigmoid``); E is then
    ``cfg.routed_experts``."""
    if cfg.router_scoring == "sigmoid":
        if is_dtensor(x):
            raise NotImplementedError("the sigmoid router is not placed")
        return _route_sigmoid(x, p["router"], p["e_score_correction_bias"],
                              cfg)
    if cfg.router_scoring != "softmax":
        raise ValueError(f"unknown router_scoring {cfg.router_scoring!r}")
    if cfg.n_group > 1 or cfg.routed_scaling_factor != 1.0:
        raise NotImplementedError(
            "group-limited or scaled routing runs with the sigmoid router "
            "only (DeepSeek-V3's); the softmax router takes the plain top-k")
    if is_dtensor(x):
        from repro_torch.distributed import parallel
        return parallel.route(_route, x, p["router"], cfg.top_k)
    return _route(x, p["router"], cfg.top_k)


def _route_sigmoid(x: torch.Tensor, router: torch.Tensor,
                   bias: torch.Tensor, cfg: ModelConfig):
    """DeepSeek-V3's router (arXiv:2412.19437 section 2.1.2, the published
    ``noaux_tc`` gate): s = sigmoid(x . W_r) in fp32 over every routed
    expert; the choice reads s + b (b the per-expert correction bias): each
    of ``n_group`` groups scores the sum of its two best, the
    ``topk_group`` best groups are kept, and the top k of the kept experts
    are taken; their weights are the unbiased s, renormalised to sum 1 and
    scaled by ``routed_scaling_factor``. Ties go to the lower group and
    expert (stable descending sorts). Returns (s, weights, experts) as
    ``_route`` does."""
    shape = x.shape[:-1]
    E, K, G = cfg.routed_experts, cfg.top_k, cfg.n_group
    scores = torch.sigmoid(_mm_f32(x.reshape(-1, x.shape[-1]), router))
    choice = scores + bias.float()
    if G > 1:
        grouped = choice.view(-1, G, E // G)
        best2 = torch.topk(grouped, 2, dim=-1).values.sum(-1)     # (N, G)
        _, order = torch.sort(best2, dim=-1, descending=True, stable=True)
        kept = torch.zeros_like(best2, dtype=torch.bool).scatter_(
            1, order[:, :cfg.topk_group], True)
        choice = grouped.masked_fill(~kept[..., None],
                                     float("-inf")).view(-1, E)
    _, idx = torch.sort(choice, dim=-1, descending=True, stable=True)
    top_idx = idx[:, :K]
    top_w = scores.gather(-1, top_idx)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-20)
    top_w = top_w * cfg.routed_scaling_factor
    return (scores.view(*shape, E), top_w.view(*shape, K),
            top_idx.view(*shape, K))


def _route(x: torch.Tensor, router: torch.Tensor, K: int):
    logits = (x @ router.to(x.dtype)).float()                    # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = vals[..., :K], idx[..., :K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_idx


def _batch_mean(t: torch.Tensor, dims) -> torch.Tensor:
    """``t.mean(dims)``; a placed ``t`` averages each rank's rows
    (``distributed.parallel.batch_mean``)."""
    if is_dtensor(t):
        from repro_torch.distributed import parallel
        return parallel.batch_mean(t, dims)
    return t.mean(dim=dims)


def _router_entropy(probs: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.sum(probs * torch.log(probs + 1e-9), -1))


def _with_shared(p, cfg: ModelConfig, y: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    if "shared" in p:
        y = y + ffn_forward(p["shared"], cfg.replace(ffn_activation="swiglu"),
                            x)
    return y


def moe_forward(p, cfg: ModelConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, MoEAux]:
    if cfg.moe_dispatch == "capacity":
        return moe_forward_capacity(p, cfg, x)
    return moe_forward_dense(p, cfg, x)


def moe_forward_dense(p, cfg: ModelConfig, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, MoEAux]:
    """x: (B,S,d). Dense one-hot dispatch: every expert runs on every token
    and the combine weights (zero off a token's top k) mask the result.
    Computes E/top_k times the routed FLOPs, as the JAX package's baseline
    does. On a chip that holds a share (``cfg.router_experts``) the router
    picks among all the routed experts, the combine is cut to the first
    ``num_experts`` (those held here), and the output is their partial sum
    plus the shared experts', which this chip adds once for its tokens."""
    E = cfg.num_experts
    probs, top_w, top_idx = route(p, cfg, x)
    onehot = (top_idx[..., None] == torch.arange(
        cfg.routed_experts, device=x.device)).float()
    combine = (onehot * top_w[..., None]).sum(-2)                # (B,S,E)
    if cfg.routed_experts != E:
        if is_dtensor(x):
            raise NotImplementedError("a share of the experts is not placed")
        combine, probs = combine[..., :E], probs[..., :E]
    experts = (p["w_gate"], p["w_in"], p["w_out"])
    shared = ()
    if is_dtensor(x):
        from repro_torch.distributed import parallel
        if "shared" in p and parallel.fuses_shared(p["w_gate"], p["shared"]):
            # the shared experts' partial sums join the experts' reduce
            shared = tuple(p["shared"][n] for n in ("w_gate", "w_in",
                                                    "w_out"))
        y = parallel.moe_experts(_dense_experts, x, combine, *experts,
                                 *shared)
    else:
        y = _dense_experts(x, combine, *experts)
    y = y.to(x.dtype)
    if not shared:
        y = _with_shared(p, cfg, y, x)
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    f = _batch_mean((combine > 0).float(), (0, 1))               # routed share
    lb = E * torch.sum(f * _batch_mean(probs, (0, 1)))
    return y, MoEAux(load_balance_loss=lb,
                     router_entropy=_router_entropy(probs))


def _dense_experts(x, combine, w_gate, w_in, w_out, *shared) -> torch.Tensor:
    """The experts of the dense dispatch, each on every token of x
    (B,S,D), weighted by combine (B,S,E) and summed: (B,S,D) fp32. E is
    the experts' own count (a rank's share on a placed step); ``shared``,
    the shared experts' (w_gate, w_in, w_out) (a rank's columns of their
    hidden layer), adds their SwiGLU FFN's output, widened."""
    B, S, D = x.shape
    E, N = w_gate.shape[0], B * S
    xe = x.reshape(N, D)[None].expand(E, N, D)
    gate = _mm_f32(xe, w_gate)                                   # (E,N,F)
    up = _mm_f32(xe, w_in)
    h = ffn_act(gate, up, "swiglu") * combine.reshape(N, E).t()[..., None]
    F_ = h.shape[-1]
    y = _mm_f32(h.transpose(0, 1).reshape(N, E * F_),
                w_out.reshape(E * F_, D))
    if shared:
        sg, si, so = (w.to(x.dtype) for w in shared)
        h = ffn_act(x @ sg, x @ si, "swiglu")
        y = y + (h @ so).reshape(N, D).float()
    return y.reshape(B, S, D)


def capacity_slots(e_flat: torch.Tensor, num_experts: int, capacity: int):
    """(slot, keep) of each of the N*K assignments ``e_flat`` (token-major):
    its arrival-order rank within its expert, kept below ``capacity`` at
    buffer row expert * capacity + rank; the rest are dropped to the spare
    row num_experts * capacity."""
    E, C = num_experts, capacity
    rank = arrival_ranks(e_flat, E)
    keep = rank < C
    return torch.where(keep, e_flat * C + rank, E * C), keep


def arrival_ranks(e_flat: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each assignment's arrival-order rank within its expert (0 for the
    first): a cumulative count over the token-major axis."""
    onehot = (e_flat[:, None] == torch.arange(
        num_experts, device=e_flat.device)).long()
    return torch.cumsum(onehot, dim=0).gather(1, e_flat[:, None])[:, 0] - 1


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """C, the buffer rows an expert of the capacity dispatch holds for
    ``n_tokens`` tokens (of the whole batch, placed or not)."""
    K, E = cfg.top_k, cfg.num_experts
    return max(int(-(-n_tokens * K // E) * cfg.capacity_factor), 1)


class WholeBuffer:
    """Where the capacity dispatch's assignments go, with nothing placed:
    every expert's C rows in one buffer, the routing's own ranks, no
    collective. ``parallel.moe_capacity`` hands ``capacity_experts`` a
    rank's share instead."""

    def __init__(self, num_experts: int, capacity: int):
        self.experts, self.rows = num_experts, capacity

    def slots(self, e_flat: torch.Tensor):
        """(slot, keep, own): each assignment's row in this buffer (the
        spare row experts * rows where it is not written here), whether the
        routing keeps it, and whether it is written here."""
        slot, keep = capacity_slots(e_flat, self.experts, self.rows)
        return slot, keep, keep

    def dispatch(self, xe: torch.Tensor) -> torch.Tensor:
        return xe

    def collect(self, ye: torch.Tensor) -> torch.Tensor:
        return ye

    def combine(self, contrib: torch.Tensor) -> torch.Tensor:
        return contrib


def capacity_experts(x, top_w, top_idx, w_gate, w_in, w_out,
                     buffer) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity dispatch's experts on x (B,S,D), its routing's top-k
    weights and experts (B,S,K) and the expert weights (E, ...) that
    ``buffer`` (``WholeBuffer``, or a rank's share of it) holds: each
    assignment's token goes to its row of the (E, C, D) buffer, the expert
    FFNs run on it, and each token sums its K contributions in a fixed
    order (no atomics). (y (B,S,D) fp32, keep (B,S,K): the assignments the
    routing kept.)"""
    B, S, D = x.shape
    K = top_idx.shape[-1]
    N = B * S
    slot, keep, own = buffer.slots(top_idx.reshape(N * K))
    held = buffer.experts * buffer.rows
    # each token once an assignment, token-major: a copy whose gradient is
    # a sum over K, in a fixed order
    xk = x.reshape(N, 1, D).expand(N, K, D).reshape(N * K, D)
    buf = torch.zeros((held + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = torch.where(own[:, None], xk, 0)
    xe = buffer.dispatch(buf[:held].reshape(buffer.experts, buffer.rows, D))
    gate = _mm_f32(xe, w_gate)
    up = _mm_f32(xe, w_in)
    ye = buffer.collect(_mm_f32(ffn_act(gate, up, "swiglu"), w_out))
    ye = ye.reshape(held, D)
    contrib = torch.where(own[:, None],
                          ye[torch.clamp(slot, max=held - 1)]
                          * top_w.reshape(N * K)[:, None], 0.0)
    contrib = buffer.combine(contrib.reshape(N, K, D))
    y = contrib[:, 0]
    for k in range(1, K):
        y = y + contrib[:, k]
    return y.reshape(B, S, D), keep.reshape(B, S, K)


def moe_forward_capacity(p, cfg: ModelConfig, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, MoEAux]:
    """Capacity dispatch: each expert's tokens go into a buffer of
    C = ceil(N*K/E) * capacity_factor rows (from the static shapes), the
    expert FFNs run on (E, C, d), and assignments past an expert's capacity
    are dropped (the shared experts still serve those tokens). Each token
    sums its K contributions in a fixed order (no atomics), so a replay of
    the step equals it bit for bit. Placed operands run on each rank's
    experts, with the routing of the whole batch
    (``distributed.parallel.moe_capacity``; ``cfg.moe_ep_constraint``
    splits the buffer's rows over the data axes too)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    if cfg.routed_experts != E:
        raise NotImplementedError(
            "the capacity dispatch routes over the experts it holds: a "
            "share of them (router_experts) runs the dense dispatch")
    probs, top_w, top_idx = route(p, cfg, x)
    C = moe_capacity(cfg, B * S)
    experts = (p["w_gate"], p["w_in"], p["w_out"])
    if is_dtensor(x):
        from repro_torch.distributed import parallel
        y, _ = parallel.moe_capacity(x, top_w, top_idx, *experts,
                                     capacity=C,
                                     split_rows=cfg.moe_ep_constraint)
    else:
        y, _ = capacity_experts(x, top_w, top_idx, *experts,
                                WholeBuffer(E, C))
    y = _with_shared(p, cfg, y.to(x.dtype), x)
    # fraction of tokens routed to each expert (matches the dense path)
    onehot = (top_idx[..., None] == torch.arange(E, device=x.device)).float()
    f = _batch_mean(onehot, (0, 1, 2)) * K
    lb = E * torch.sum(f * _batch_mean(probs, (0, 1)))
    return y, MoEAux(load_balance_loss=lb,
                     router_entropy=_router_entropy(probs))


# ---------------------------------------------------------------------------
# Shared: depthwise causal conv
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv along seq. x (B,S,W), w (k,W), tail (B,k-1,W).
    Returns (out (B,S,W), new_tail (B,k-1,W)). Placed operands convolve
    each rank's channels (``distributed.parallel.local_conv``)."""
    if is_dtensor(x):
        from repro_torch.distributed import parallel
        return parallel.local_conv(_causal_conv, x, w, tail)
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)                       # (B,S+k-1,W)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i][None, None] for i in range(k))
    new_tail = xp[:, -(k - 1):] if k > 1 else tail
    if S > 1:
        # a copy, so that a prefill's state does not hold all of xp
        new_tail = new_tail.clone()
    return out, new_tail


# ---------------------------------------------------------------------------
# RG-LRU (Real-Gated Linear Recurrent Unit): RecurrentGemma / Griffin
# ---------------------------------------------------------------------------

#: the RG-LRU block's weights that only fp32 products use: held in fp32
GATES_FP32 = ("w_input_gate", "w_rec_gate")


def widened_leaves(params, cfg: ModelConfig) -> list:
    """The ``GATES_FP32`` leaves of a params tree where the config's weight
    dtype is narrower than fp32: values of that dtype held in fp32. The JAX
    package holds them in the weight dtype, so a trainer rounds them (and
    their gradients) back to its grid after each update."""
    if cfg.weight_dtype == torch.float32:
        return []
    found = []

    def walk(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k in GATES_FP32:
                    found.append(v)
                else:
                    walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)

    walk(params)
    return found


class RGLRUState(NamedTuple):
    h: torch.Tensor         # (B, lru_width) recurrent state, fp32
    conv: torch.Tensor      # (B, k-1, lru_width) conv tail


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig):
    dt = cfg.weight_dtype
    W = cfg.lru_width
    lam = 0.9 + 0.099 * uniform_init(gen, (W,))
    return {
        "w_x": dense_init(gen, (cfg.d_model, W), dt),
        "w_y": dense_init(gen, (cfg.d_model, W), dt),  # multiplicative branch
        "conv_w": dense_init(gen, (cfg.conv_kernel, W), dt, scale=0.5),
        "lambda_param": lam,
        "w_input_gate": dense_init(gen, (W, W), dt, scale=0.02).float(),
        "w_rec_gate": dense_init(gen, (W, W), dt, scale=0.02).float(),
        "w_out": dense_init(gen, (W, cfg.d_model), dt),
    }


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
    out. x: (B,S,d_model). Works for S==1 (decode) given a state. After its
    three products, the gates, the recurrence (Griffin's c = 8) and the
    output gate are one call at every S, a decode step's included
    (``rglru_gated_scan``: one kernel launch with ``use_pallas``). Its
    one-step scan is the JAX package's inline decode step."""
    B, S, _ = x.shape
    W = cfg.lru_width
    # (B,S,W) each: the recurrence's input and the y branch
    xb, pre_y = matmul(x, p["w_x"].to(x.dtype), p["w_y"].to(x.dtype))
    tail = state.conv if state is not None else None
    xc, new_tail = _causal_conv(xb, p["conv_w"].to(xb.dtype), tail)
    xc32 = xc.float()
    pre_i, pre_r = matmul(xc32, p["w_input_gate"].float(),
                          p["w_rec_gate"].float())
    h0 = (state.h if state is not None
          else torch.zeros((B, W), dtype=torch.float32, device=x.device))
    if cfg.use_pallas:
        from repro_torch.kernels import ops as kops
        gated_scan = kops.rglru_gated_scan
    else:
        from repro_torch.kernels.ref import rglru_gated_scan as gated_scan
    if is_dtensor(xc32):
        from repro_torch.distributed import parallel
        out, h_last = parallel.local_scan(gated_scan, xc32, pre_i, pre_r,
                                          p["lambda_param"], pre_y, h0)
    else:
        out, h_last = gated_scan(xc32, pre_i, pre_r, p["lambda_param"],
                                 pre_y, h0)
    y = matmul(out, p["w_out"].to(x.dtype))
    if state is None:
        return y, RGLRUState(h=h_last, conv=new_tail)
    state.h.copy_(h_last)
    state.conv.copy_(new_tail)
    return y, state


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
    """(z, xBC, dt) of the fused in-projection. Placed, each rank takes its
    heads' columns of z and dt and the conv's channel split of xBC
    (``distributed.parallel.ssd_parts``)."""
    d_in = cfg.d_inner
    G, N, H = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    zxbcdt = matmul(u, p["w_in"].to(u.dtype))
    sizes = [d_in, d_in + 2 * G * N, H]
    if is_dtensor(zxbcdt):
        from repro_torch.distributed import parallel
        return parallel.ssd_parts(zxbcdt, sizes, (0, 1, 2), H)
    return torch.split(zxbcdt, sizes, dim=-1)


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
    recurrent decode step, which writes the new state into ``state.ssm``
    itself (with ``cfg.use_pallas`` through the ``ssd_step`` kernel, else
    plain PyTorch, as in the JAX package). Placed operands run the SSD on
    each rank's heads (``distributed.parallel.ssd_heads``)."""
    z, xBC, dt = _ssd_split(p, cfg, u)
    tail = state.conv if state is not None else None
    xBC, new_tail = _causal_conv(xBC, p["conv_w"].to(xBC.dtype), tail)
    GN = cfg.ssm_ngroups * cfg.ssm_state
    sizes = [cfg.d_inner, GN, GN]
    rest = (dt, p["dt_bias"], p["A_log"], p["D"],
            state.ssm if state is not None else None)
    if is_dtensor(xBC):
        # each rank takes its heads' channels of x, and B and C whole
        # (every head reads the one group's)
        from repro_torch.distributed import parallel

        def heads(z_, x_, b_, c_, *a):
            return _ssd_heads(cfg, z_, *(F.silu(t.float()) for t in
                                         (x_, b_, c_)), *a)
        xbc = parallel.ssd_parts(xBC, sizes, (0,), cfg.ssm_nheads)
        y, final = parallel.ssd_heads(heads, cfg.ssm_nheads, z, *xbc, *rest)
    else:
        x, Bmat, Cmat = torch.split(F.silu(xBC.float()), sizes, dim=-1)
        y, final = _ssd_heads(cfg, z, x, Bmat, Cmat, *rest)
    # gated RMSNorm (mamba2 style): norm(y * silu(z)), on the plain path
    # with or without the kernels, as in the JAX package
    y = rms_norm(y.to(u.dtype), p["norm_w"], cfg.norm_eps)
    out = matmul(y, p["w_out"].to(u.dtype))
    if state is None:
        return out, SSDState(ssm=final, conv=new_tail)
    if u.shape[1] > 1:
        state.ssm.copy_(final)
    if is_dtensor(new_tail):
        # the tail as the cache holds it (rows whole where the cache's
        # layer split does not divide the data axes)
        from repro_torch.distributed import parallel
        new_tail, = parallel.placed_as([new_tail], [state.conv])
    state.conv.copy_(new_tail)
    return out, state


def _ssd_heads(cfg: ModelConfig, z, x, Bmat, Cmat, dt, dt_bias, A_log, D,
               ssm):
    """The SSD of the heads that z, x (B,S,h*P) and dt (B,S,h) hold, with
    their dt_bias, A_log and D (h,), and the output gate: (y * silu(z)
    (B,S,h*P) fp32, the final state (B,h,P,N)). x, and B and C (B,S,G*N),
    every head's, are the conv's output through silu, fp32; ``ssm`` is a
    decode step's state of these heads (scaled and added into in place)
    or None."""
    Bsz, S, _ = x.shape
    G, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_head_dim
    H = dt.shape[-1]
    if H != cfg.ssm_nheads:
        # every head reads the one group's B and C (each config's
        # ssm_ngroups is 1)
        assert G == 1, f"a split over heads needs ssm_ngroups 1, not {G}"
    x = x.reshape(Bsz, S, H, P)
    Bmat = Bmat.reshape(Bsz, S, G, N)
    Cmat = Cmat.reshape(Bsz, S, G, N)
    dt = F.softplus(dt.float() + dt_bias)                    # (B,S,H)
    A = torch.exp(A_log)                                     # (H,) > 0
    if S == 1 and ssm is not None:
        # recurrent step: S' = exp(-dt*A) S + dt * B x^T ; y = C.S' + D x,
        # S' written into ``ssm``; with cfg.use_pallas through the kernel
        # (``kernels.ssd_step``)
        from repro_torch.kernels import ops as kops, ref
        args = (x[:, 0], dt[:, 0], A, Bmat[:, 0], Cmat[:, 0], D, ssm)
        y = kops.ssd_step(*args) if cfg.use_pallas else ref.ssd_step(*args)
        final = ssm
        y = y[:, None]                                       # (B,1,H,P)
    else:
        # a prefill starts from a zero state, as in the JAX package
        y, final = ssd_chunked(x, dt, A, Bmat, Cmat, cfg.ssm_chunk,
                               use_pallas=cfg.use_pallas)
        y = y + D[None, None, :, None] * x
    y = y.reshape(Bsz, S, H * P)
    return y * F.silu(z.float()), final


def init_ssd_state(cfg: ModelConfig, batch: int,
                   device="cuda") -> SSDState:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return SSDState(
        ssm=torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                         dtype=cfg.activation_dtype, device=device))
