"""Shared model machinery of the port: the config dataclass, norms (RMSNorm,
and whisper's LayerNorm), rope, whisper's sinusoidal positions and
initializers.

``ModelConfig`` has the fields, defaults, ``replace()``, ``reduced()`` and
``q_per_kv`` of ``repro.models.common.ModelConfig``, so configs convert
field for field through ``dataclasses.asdict``; only the dtype properties
return torch dtypes. It adds the port-only fields of ``PORT_FIELDS``
(DeepSeek-V3's compressed queries and router, and a chip's share of the
experts), whose defaults leave every other model's path as it was. ``use_pallas`` keeps its name and means "run the
hand-written Hopper kernels" (``repro_torch.kernels``). Params are plain
dicts of tensors in the JAX package's layouts: (in, out) weight matrices
applied as ``x @ W`` and (B, S, H, D) attention tensors.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for every supported family."""

    name: str = "model"
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1024

    # ffn / norm flavour
    ffn_activation: str = "swiglu"  # swiglu | squared_relu | gelu
    use_qk_norm: bool = False       # chameleon-style qk layernorm
    norm_eps: float = 1e-6

    # positional encoding
    use_rope: bool = True
    rope_theta: float = 10000.0

    # attention variants
    attention_window: int = 0       # 0 = full attention; >0 = sliding window

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 1
    moe_d_ff: int = 0               # per-expert hidden dim (deepseek style)
    first_k_dense: int = 0          # leading dense layers (deepseek)
    router_jitter: float = 0.0
    # port-only (PORT_FIELDS): DeepSeek-V3's router, sigmoid scores with a
    # per-expert correction bias that picks (not weighs) the experts, among
    # the topk_group best of n_group groups, the weights scaled after their
    # renormalisation; and a chip's share of the experts: num_experts held
    # here of router_experts routed over (0 = all of them)
    router_scoring: str = "softmax"  # softmax | sigmoid
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    router_experts: int = 0

    # MLA (deepseek)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0            # port-only: 0 = the direct wq
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_ngroups: int = 1
    conv_kernel: int = 4

    # hybrid (recurrentgemma / griffin)
    block_pattern: Tuple[str, ...] = ()   # cycled over layers, e.g. ("rec","rec","attn")
    lru_width: int = 0
    local_window: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper frame count after conv frontend

    # modality frontend stub (vlm/audio): if set, inputs may be embeddings
    frontend_stub: str = ""          # "" | "audio_frames" | "vq_image_tokens"

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # execution
    use_pallas: bool = False         # True: the Hopper kernels
    remat: bool = True               # checkpoint layer bodies in training
    # KV-cache write mechanism for decode: "onehot" (paper-era baseline,
    # reads+writes the whole cache each step) or "scatter"
    # (dynamic_update_slice, O(1) traffic — the optimized default; see
    # EXPERIMENTS.md §Perf for the before/after).
    kv_update: str = "onehot"
    # Full-sequence attention reference path: "naive" materializes the SxS
    # score matrix (baseline; what the Pallas kernel replaces on TPU);
    # "chunked" streams KV blocks with a running softmax (flash-style jnp) —
    # §Perf iteration 1, bounded temps for 32k prefill.
    ref_attention: str = "naive"
    # MoE dispatch: "dense" (einsum over ALL experts — baseline, E/top_k
    # FLOPs waste) or "capacity" (scatter/gather per-expert buffers — §Perf
    # compute-term optimization).
    moe_dispatch: str = "dense"
    capacity_factor: float = 1.25
    # apply an explicit expert-parallel sharding constraint to the capacity
    # dispatch buffers (GSPMD cannot propagate sharding through the
    # data-dependent scatter; requires an active mesh context)
    moe_ep_constraint: bool = False
    # Unroll layer stacks instead of lax.scan. Used by the roofline cost
    # extrapolation: XLA cost_analysis counts a scan body ONCE regardless of
    # trip count, so exact per-layer FLOPs/bytes come from compiling small
    # unrolled variants (see launch/dryrun.py --cost-extrapolate).
    unroll_layers: bool = False

    # provenance
    source: str = ""                 # citation per assignment

    # ------------------------------------------------------------------
    @property
    def routed_experts(self) -> int:
        """The experts the router scores: all of them, or, on a chip that
        holds a share, ``router_experts``."""
        return self.router_experts or self.num_experts

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (spec: <=2 layers,
        d_model<=512, <=4 experts)."""
        kw = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads)),
            head_dim=64,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            dtype="float32",
            param_dtype="float32",
        )
        if self.num_experts:
            kw.update(num_experts=4, top_k=min(self.top_k, 2),
                      num_shared_experts=min(self.num_shared_experts, 1),
                      moe_d_ff=min(self.moe_d_ff or self.d_ff, 256),
                      first_k_dense=min(self.first_k_dense, 1))
        if self.use_mla:
            kw.update(kv_lora_rank=64, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32)
        if self.arch_type == "ssm":
            kw.update(ssm_state=32, ssm_head_dim=32, ssm_chunk=16)
        if self.arch_type == "hybrid":
            kw.update(lru_width=256, local_window=32, num_layers=3)
        if self.is_encoder_decoder:
            kw.update(encoder_layers=2, encoder_seq=16)
        if self.attention_window:
            kw.update(attention_window=32)
        return self.replace(**kw)


#: the fields the JAX package's config does not have, and their defaults
PORT_FIELDS = {name: ModelConfig.__dataclass_fields__[name].default
               for name in ("q_lora_rank", "router_scoring", "n_group",
                            "topk_group", "routed_scaling_factor",
                            "router_experts")}


# ---------------------------------------------------------------------------
# Devices and initializers
# ---------------------------------------------------------------------------

def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` is the default of every
    entry point; asking for it without a card raises instead of carrying
    on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def tree_tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of a params or cache tree (nested dicts, lists and
    named tuples), in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_tensors(v)


def tree_map(fn, tree):
    """A tree of the same containers with ``fn`` of each tensor, in
    ``tree_tensors``' order."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return type(tree)(*(tree_map(fn, v) for v in tree))   # a named tuple


def tree_clone(tree):
    """A copy of a cache tree, its containers alike, its tensors cloned."""
    return tree_map(torch.Tensor.clone, tree)


class ShapeOnly:
    """A generator's stand-in for a model's ``init``: given it, ``init``
    builds the same tree, leaf for leaf (shapes, dtypes, the widened
    ``GATES_FP32`` weights), of meta tensors (no memory) and draws
    nothing."""
    device = torch.device("meta")


def init_shapes(model):
    """``model.init`` with nothing drawn, the counterpart of
    ``jax.eval_shape(model.init, key)``: its tree of meta tensors."""
    return model.init(ShapeOnly())


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-ish), matching llama-family.
    Drawn in fp32 on the generator's device, then cast. A ``ShapeOnly``
    generator gives the empty tensor."""
    if isinstance(gen, ShapeOnly):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def uniform_init(gen: torch.Generator, shape) -> torch.Tensor:
    """fp32 values drawn uniformly from [0, 1) on the generator's device,
    or the empty tensor from a ``ShapeOnly`` generator."""
    if isinstance(gen, ShapeOnly):
        return torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             use_pallas: bool = False) -> torch.Tensor:
    """The plain path is the kernel's own plain version, so the model and
    the kernel's check share one reference. A DTensor whose last dim is
    split sums its squares over the shards
    (``distributed.parallel.rms_norm``); on one whose last dim is whole the
    norm is local."""
    if use_pallas:
        from repro_torch.kernels import ops as kops
        return kops.rmsnorm(x, weight, eps=eps)
    from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain
    if is_dtensor(x) and is_dtensor(weight):
        from repro_torch.distributed import parallel
        if parallel.last_dim_split(x):
            return parallel.rms_norm(x, weight, eps)
    return rmsnorm_plain(x, weight, eps=eps)


def add_rms_norm(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-6, use_pallas: bool = False):
    """The residual add and the norm after it, (x + r, rms_norm(x + r)):
    one kernel launch with ``use_pallas``, the plain add and norm without.
    ``r`` None is the norm alone, (x, rms_norm(x))."""
    if r is None:
        return x, rms_norm(x, weight, eps, use_pallas)
    if use_pallas:
        from repro_torch.kernels import ops as kops
        return kops.add_rmsnorm(x, r, weight, eps=eps)
    from repro_torch.kernels.ref import add_rmsnorm as add_rmsnorm_plain
    return add_rmsnorm_plain(x, r, weight, eps=eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with bias (whisper), as the JAX package computes it: the
    mean and the population variance in fp32, then cast back to x's dtype.
    It runs no kernel, in the port as in the JAX package."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def ffn_act(x_gate, x_up, kind: str):
    """Combine gate/up projections per the configured activation."""
    if kind == "swiglu":
        return F.silu(x_gate) * x_up
    if kind == "squared_relu":            # nemotron-4
        r = F.relu(x_gate)
        return r * r
    if kind == "gelu":                    # whisper / starcoder-style
        return F.gelu(x_gate, approximate="tanh")
    if kind == "geglu":                   # recurrentgemma MLP
        return F.gelu(x_gate, approximate="tanh") * x_up
    raise ValueError(f"unknown ffn activation {kind!r}")


def is_gated(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. A DTensor table is looked up shard by shard and
    the shards' rows summed (``distributed.parallel.embedding``)."""
    if is_dtensor(table):
        from repro_torch.distributed import parallel
        return parallel.embedding(table, tokens)
    return table[tokens]


def stack_layers(tensors) -> torch.Tensor:
    """``torch.stack(tensors)``: each layer's tensor on a new leading axis.
    DTensors (one placement) are stacked shard by shard
    (``distributed.parallel.stack_layers``)."""
    if is_dtensor(tensors[0]):
        from repro_torch.distributed import parallel
        return parallel.stack_layers(list(tensors))
    return torch.stack(tensors)


def unstack(t: torch.Tensor):
    """The per-layer views of a tensor stacked over layers (dim 0), the
    inverse of ``stack_layers``. A DTensor is unstacked shard by shard
    (``distributed.parallel.unstack``)."""
    if is_dtensor(t):
        from repro_torch.distributed import parallel
        return parallel.unstack(t)
    return [t[i] for i in range(t.shape[0])]


def split_dim(t: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``t`` with dim ``dim`` viewed as ``sizes`` (their product is its
    length). A DTensor is viewed shard by shard, its split of that dim
    kept where it divides ``sizes[0]`` (``distributed.parallel
    .split_dim``)."""
    if is_dtensor(t):
        from repro_torch.distributed import parallel
        return parallel.split_dim(t, dim, sizes)
    return t.reshape(t.shape[:dim] + tuple(sizes) + t.shape[dim + 1:])


def merge_dims(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with dims ``dim`` and ``dim + 1`` viewed as one; a DTensor
    shard by shard (``distributed.parallel.merge_dims``)."""
    if is_dtensor(t):
        from repro_torch.distributed import parallel
        return parallel.merge_dims(t, dim)
    return t.reshape(t.shape[:dim] + (-1,) + t.shape[dim + 2:])


def matmul(x: torch.Tensor, *ws: torch.Tensor):
    """``x @ w`` of an activation and each weight (K, N): one product for
    one weight, else a tuple. Placed weights (DTensors) take Megatron's
    split their placement names, the products of one input in one region
    (``distributed.parallel.linear``)."""
    if any(is_dtensor(w) for w in ws) or is_dtensor(x):
        from repro_torch.distributed import parallel
        return parallel.linear(x, *ws)
    out = tuple(x @ w for w in ws)
    return out if len(out) > 1 else out[0]


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                     # (head_dim//2,)


class RopeTables(NamedTuple):
    """sin and cos of each position's angles, (..., seq, 1, head_dim//2):
    what ``apply_rope`` rotates by. A model builds them once a forward or
    decode step and hands them to every attention layer."""
    sin: torch.Tensor
    cos: torch.Tensor


def model_rope(cfg: ModelConfig,
               positions: torch.Tensor) -> Optional[RopeTables]:
    """The tables of ``positions`` (broadcastable to (..., seq)) that a
    model's attention layers share, None without rope. They rotate the
    width that the model's attention rotates: ``qk_rope_head_dim`` under
    MLA, ``head_dim`` otherwise."""
    if not cfg.use_rope:
        return None
    width = cfg.qk_rope_head_dim if cfg.use_mla else cfg.head_dim
    freqs = rope_frequencies(width, cfg.rope_theta, device=positions.device)
    angles = positions[..., :, None].float() * freqs      # (..., seq, hd/2)
    return RopeTables(sin=torch.sin(angles)[..., :, None, :],
                      cos=torch.cos(angles)[..., :, None, :])


def apply_rope(x: torch.Tensor, tables: RopeTables) -> torch.Tensor:
    """x: (..., seq, heads, head_dim), rotated by ``tables``
    (``model_rope`` of its positions). Split-half layout: the first and
    second halves of head_dim rotate together (not interleaved pairs)."""
    sin, cos = tables
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Sinusoidal positions (whisper)
# ---------------------------------------------------------------------------

def inverse_timescales(dim: int, device) -> torch.Tensor:
    """(dim // 2,) fp32: exp(-i log(10000) / (dim // 2 - 1)), every step in
    fp32 as the JAX package takes it, on ``device`` from no host value."""
    f32 = dict(dtype=torch.float32, device=device)
    log_timescale = torch.full((), 10000.0, **f32).log() / (dim // 2 - 1)
    return torch.exp(-log_timescale * torch.arange(dim // 2, **f32))


def sinusoids(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Whisper-style fixed sinusoids of the positions ``t`` (any shape),
    (..., dim) fp32: sin then cos of t times the inverse timescales. Built
    on t's device with no host sync, so a decode step that calls it
    captures as a CUDA graph."""
    angles = t.float()[..., None] * inverse_timescales(dim, t.device)
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def sinusoidal_positions(length: int, dim: int,
                         device="cuda") -> torch.Tensor:
    """The sinusoids of positions 0..length-1, (length, dim) fp32."""
    return sinusoids(torch.arange(length, device=device), dim)


# ---------------------------------------------------------------------------
# Training: the loss and rematerialisation
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean next-token loss. logits (B,S,V) of any float dtype, labels (B,S)
    int: the logsumexp minus the label's logit in fp32 (in fp64 for fp64
    logits), averaged over the tokens, or over those ``mask`` weights (at
    least 1). Logits that are a DTensor take each rank's rows: split over
    the vocab, the vocab-parallel form (``distributed.parallel
    .vocab_parallel_nll``), which gathers no logits; else ``token_nll`` on
    each rank's own rows (``distributed.parallel.rows_nll``)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    if is_dtensor(logits):
        from repro_torch.distributed import parallel
        nll = (parallel.vocab_parallel_nll if parallel.vocab_split(logits)
               else parallel.rows_nll)
        return _mean_nll(nll(logits, labels), mask)
    return _mean_nll(token_nll(logits, labels), mask)


class _TokenNLL(torch.autograd.Function):
    """``token_nll``, whose backward pass builds the gradient in one buffer
    (B, S, V): exp(logits - lse) scaled by the incoming gradient, and the
    label's entry lowered by it. Autograd's own backward of the same ops
    holds four such buffers (the difference, its exp, the product and the
    gather's scatter) and sums the two parts after; every entry rounds
    alike (products and sums of two terms commute exactly). The logsumexp
    takes ``torch.logsumexp``'s steps as ops of their own, so that the
    dry-run's memory count sees the buffer it holds (the kernel's own
    temporaries are not seen)."""

    @staticmethod
    def forward(ctx, logits, labels):
        m = logits.amax(dim=-1, keepdim=True)
        m = m.masked_fill(m.abs() == float("inf"), 0.0)
        lse = torch.sub(logits, m).exp_().sum(dim=-1).log_().add_(m[..., 0])
        idx = labels.long()[..., None]
        ll = torch.gather(logits, -1, idx)[..., 0]
        ctx.save_for_backward(logits, lse, idx)
        return lse - ll

    @staticmethod
    def backward(ctx, grad):
        logits, lse, idx = ctx.saved_tensors
        g = torch.sub(logits, lse[..., None]).exp_().mul_(grad[..., None])
        return g.scatter_add_(-1, idx, -grad[..., None]), None


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The per-token loss (B, S): the logsumexp minus the label's logit."""
    return _TokenNLL.apply(logits, labels)


def is_dtensor(t: torch.Tensor) -> bool:
    """Whether ``t`` is a DTensor, without importing DTensor where nothing
    has made one."""
    tensor_mod = sys.modules.get("torch.distributed.tensor")
    return tensor_mod is not None and isinstance(t, tensor_mod.DTensor)


def _mean_nll(nll: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def remat(enabled: bool, fn, *args):
    """``fn(*args)``, the counterpart of the JAX package's ``remat_wrap``
    around a layer body: where ``enabled`` (``cfg.remat``), autograd is
    recording and a tensor of ``args`` requires grad, it runs under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps the inputs
    alone and recomputes the body's activations in the backward pass.
    Otherwise (serving, the graph captures) it is the plain call."""
    if _checkpoints(enabled, args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _checkpoints(enabled: bool, args) -> bool:
    return enabled and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_tensors(args))


def remat_residual(enabled: bool, fn, *args):
    """``remat`` of a layer body that takes and returns the residual stream
    as (x, pending, ...): the stream before its last add and that add's
    other operand, which the next layer's norm adds in (``add_rms_norm``).
    Where it checkpoints, the body returns x + pending (the add the next
    norm would make, bit for bit) and no pending, so that each checkpoint
    keeps one tensor of the stream, as the JAX package's scan carries one
    a layer, not two. Otherwise the plain call."""
    if not _checkpoints(enabled, args):
        return fn(*args)

    def summed(*a):
        x, pending, *rest = fn(*a)
        return (x if pending is None else x + pending, None, *rest)
    return checkpoint(summed, *args, use_reentrant=False,
                      preserve_rng_state=False)
