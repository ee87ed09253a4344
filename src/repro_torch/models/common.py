"""Shared model machinery of the port: the config dataclass, norms, rope and
initializers.

``ModelConfig`` has the fields, defaults, ``replace()``, ``reduced()`` and
``q_per_kv`` of ``repro.models.common.ModelConfig``, so configs convert
field for field through ``dataclasses.asdict``; only the dtype properties
return torch dtypes. ``use_pallas`` keeps its name and means "run the
hand-written Hopper kernels" (``repro_torch.kernels``). Params are plain
dicts of tensors in the JAX package's layouts: (in, out) weight matrices
applied as ``x @ W`` and (B, S, H, D) attention tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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

    # MLA (deepseek)
    use_mla: bool = False
    kv_lora_rank: int = 0
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


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-ish), matching llama-family.
    Drawn in fp32 on the generator's device, then cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             use_pallas: bool = False) -> torch.Tensor:
    """The plain path is the kernel's own plain version, so the model and
    the kernel's check share one reference."""
    if use_pallas:
        from repro_torch.kernels import ops as kops
        return kops.rmsnorm(x, weight, eps=eps)
    from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain
    return rmsnorm_plain(x, weight, eps=eps)


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

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                     # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    Split-half layout: the first and second halves of head_dim rotate
    together (not interleaved pairs)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)
    angles = positions[..., :, None].float() * freqs      # (..., seq, hd/2)
    sin = torch.sin(angles)[..., :, None, :]              # (..., seq, 1, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
