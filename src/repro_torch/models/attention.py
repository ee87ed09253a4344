"""Attention of the port: GQA prefill and decode, the KV cache and its
sliding-window ring buffer, the chunked (streaming-softmax) reference, MLA
(DeepSeek-V2's multi-head latent attention over a compressed cache) and
whisper's cross-attention to precomputed encoder K/V. Plain paths are
PyTorch; with ``cfg.use_pallas`` the hand-written Hopper kernels of
``repro_torch.kernels`` run GQA's causal prefill and decode and MLA's
decode instead (on a CPU tensor their plain versions run). MLA's decode
attends in the latent space (``_mla_absorbed``), which the JAX package
does not: the same sum, with no cached latent up-projected. MLA's prefill
and cross-attention attend through the plain einsums, as the JAX package
does.

The decode caches are updated in place: ``attention_decode`` and
``mla_decode`` write the new token's entries into the cache tensors they
were given and return them. What every attention layer of a step shares,
the rope tables (``common.model_rope``) and the slots written and read
(``decode_slots``), the models build once a step and pass down.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import (ModelConfig, RopeTables, apply_rope,
                                       dense_init, is_dtensor, matmul,
                                       merge_dims, rms_norm, split_dim)

NEG_INF = -1e30

# threshold above which full-sequence attention switches to the chunked
# (flash-style) reference path when ``ref_attention="chunked"``; small
# shapes keep the naive path
CHUNKED_ATTENTION_MIN_SEQ = 1024


# ---------------------------------------------------------------------------
# Core scaled-dot-product helpers (plain paths)
# ---------------------------------------------------------------------------

def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], *,
                  causal: bool = False,
                  use_pallas: bool = False) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,Hkv,D); mask: broadcastable (B,1,S,T) bool.

    Grouped-query: H = G*Hkv query heads share each kv head. DTensor
    operands attend shard by shard (``distributed.parallel
    .local_attention``; over a cache whose slots are split, through
    ``gqa_attention_partial``).
    """
    if is_dtensor(q) or is_dtensor(k):
        from repro_torch.distributed import parallel
        return parallel.local_attention(gqa_attention, q, k, v, mask,
                                        partial=gqa_attention_partial,
                                        causal=causal, use_pallas=use_pallas)
    if use_pallas and causal and mask is None and q.shape[1] == k.shape[1]:
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=True)
    B, S, H, D = q.shape
    probs = torch.softmax(_gqa_scores(q, k, mask, causal), dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def _gqa_scores(q, k, mask, causal: bool = False) -> torch.Tensor:
    """The masked fp32 scores (B, Hkv, G, S, T) of q (B,S,H,D) against k
    (B,T,Hkv,D), NEG_INF off the mask and, with ``causal``, above the
    diagonal."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, D).float()
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) * (D ** -0.5)
    if causal:
        cm = torch.tril(torch.ones((S, T), dtype=torch.bool,
                                   device=q.device), diagonal=T - S)
        scores = torch.where(cm, scores, NEG_INF)
    if mask is not None:
        m = mask[:, :, None] if mask.ndim == 4 else mask
        scores = torch.where(m, scores, NEG_INF)
    return scores


def _softmax_parts(scores: torch.Tensor, v: torch.Tensor, spec: str):
    """A softmax over the last dim of ``scores`` in three fp32 parts to
    combine with other parts of the keys': the max m, the sum l of
    exp(scores - m), and the product acc of those weights with v
    (``torch.einsum(spec, weights, v)``). Over all parts the output is
    sum(acc e^(m - M)) / sum(l e^(m - M)), M the max of the m."""
    mx = scores.amax(dim=-1)
    e = torch.exp(scores - mx[..., None])
    return mx, e.sum(dim=-1), torch.einsum(spec, e, v.float())


def gqa_attention_partial(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, mask: torch.Tensor):
    """``gqa_attention`` over one part of the keys (``_softmax_parts``): m
    and l (B, Hkv, G, S), acc (B, Hkv, G, S, D)."""
    return _softmax_parts(_gqa_scores(q, k, mask), v, "bhgst,bthd->bhgsd")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor, *,
                     use_pallas: bool = False) -> torch.Tensor:
    """Single-token attention. q: (B,1,H,D); caches: (B,T,Hkv,D);
    valid: (B,T) bool marking live cache slots."""
    if use_pallas:
        from repro_torch.kernels import ops as kops
        return kops.decode_attention(q, k_cache, v_cache, valid)
    mask = valid[:, None, None, :]                        # (B,1,1,T)
    return gqa_attention(q, k_cache, v_cache, mask)


def flash_attention_chunked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0,
                            block_k: int = 512) -> torch.Tensor:
    """Memory-bounded reference attention: a loop over ``block_k`` slices of
    the keys with a running (m, l, acc) streaming softmax in fp32, the
    counterpart of ``repro.models.attention.flash_attention_jnp``. Its
    temporaries are O(S * block_k) instead of O(S * T).

    q: (B,S,H,Dk); k: (B,T,Hkv,Dk); v: (B,T,Hkv,Dv). Query and key absolute
    positions are their indices (the prefill convention); ``window`` keeps
    keys j in (i - window, i]. DTensor operands attend shard by shard
    (``distributed.parallel.local_attention``)."""
    if is_dtensor(q) or is_dtensor(k):
        from repro_torch.distributed import parallel
        return parallel.local_attention(_chunked_attention, q, k, v, None,
                                        causal=causal, window=window,
                                        block_k=block_k)
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Hkv
    f32 = dict(dtype=torch.float32, device=q.device)
    qg = q.reshape(B, S, Hkv, G, D).float() * (D ** -0.5)
    rows = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, S, Hkv, G), NEG_INF, **f32)
    l = torch.zeros((B, S, Hkv, G), **f32)
    acc = torch.zeros((B, S, Hkv, G, Dv), **f32)
    for j0 in range(0, T, block_k):
        kj = k[:, j0:j0 + block_k].float()
        vj = v[:, j0:j0 + block_k].float()
        cols = torch.arange(j0, j0 + kj.shape[1], device=q.device)[None, :]
        mask = torch.ones((S, kj.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (cols <= rows)
        if window:
            mask = mask & (cols > rows - window)
        mask = mask[None, :, None, None, :]
        s = torch.einsum("bshgd,bthd->bshgt", qg, kj)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bshgt,bthd->bshgd",
                                                    p, vj)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = acc / l[..., None]
    return out.reshape(B, S, H, Dv).to(q.dtype)


def _chunked_attention(q, k, v, mask, **kw):
    """``flash_attention_chunked`` in the form ``local_attention`` calls
    (the mask is None: the chunked path masks by position)."""
    return flash_attention_chunked(q, k, v, **kw)


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, *,
                   num_kv: Optional[int] = None):
    """Standard fused-proj GQA attention params."""
    num_kv = cfg.num_kv_heads if num_kv is None else num_kv
    dt = cfg.weight_dtype
    p = {
        "wq": dense_init(gen, (cfg.d_model, cfg.num_heads * cfg.head_dim), dt),
        "wk": dense_init(gen, (cfg.d_model, num_kv * cfg.head_dim), dt),
        "wv": dense_init(gen, (cfg.d_model, num_kv * cfg.head_dim), dt),
        "wo": dense_init(gen, (cfg.num_heads * cfg.head_dim, cfg.d_model), dt),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = torch.ones((cfg.head_dim,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.ones((cfg.head_dim,), dtype=dt, device=gen.device)
    return p


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor, num_kv: int, *,
                 kv_read: bool = False):
    """q (B,S,H,D), k and v (B,S,num_kv,D). With ``kv_read``, placed k and v
    may come as the kv heads that each rank reads, repeated
    (``distributed.parallel.kv_heads``): what a whole sequence's attention
    takes, where a decode step writes whole heads into its cache."""
    q, k, v = matmul(x, *(p[n].to(x.dtype) for n in ("wq", "wk", "wv")))
    q = split_dim(q, 2, (cfg.num_heads, cfg.head_dim))
    if kv_read and is_dtensor(k):
        from repro_torch.distributed import parallel
        k, v = (parallel.kv_heads(t, num_kv, cfg.head_dim, cfg.num_heads)
                for t in (k, v))
    else:
        k = split_dim(k, 2, (num_kv, cfg.head_dim))
        v = split_dim(v, 2, (num_kv, cfg.head_dim))
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


# ---------------------------------------------------------------------------
# KV cache containers
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Per-layer decode cache. Full mode: length = max_len; window mode:
    ring buffer of length = window, indexed with pos % window. A model's
    stacked cache holds (L, B, T, Hkv, D) tensors."""
    k: torch.Tensor        # (B, T, Hkv, D)
    v: torch.Tensor        # (B, T, Hkv, D)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  *, num_kv: Optional[int] = None,
                  head_dim: Optional[int] = None,
                  device="cuda") -> KVCache:
    num_kv = cfg.num_kv_heads if num_kv is None else num_kv
    head_dim = cfg.head_dim if head_dim is None else head_dim
    length = cfg.attention_window or max_len
    shape = (batch, length, num_kv, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.activation_dtype, device=device))


class DecodeSlots(NamedTuple):
    """Where a decode step writes each row's new K/V and which slots it
    then reads, the same for every attention layer of one window kind."""
    rows: torch.Tensor     # (B,) 0..B-1
    slot: torch.Tensor     # (B,) the slot each row writes
    valid: torch.Tensor    # (B, T) the live slots after the write


def decode_slots(cfg: ModelConfig, cache_len: int, pos: torch.Tensor,
                 window: int = 0) -> DecodeSlots:
    """The slots of a decode step at ``pos`` (B,) tokens already in a cache
    of ``cache_len`` slots; ``window`` (or the config's) makes it a ring."""
    w = window or cfg.attention_window
    slot = (torch.remainder(pos, cache_len) if w
            else torch.clamp(pos, max=cache_len - 1))
    valid = cache_positions(cfg.replace(attention_window=w), cache_len,
                            pos + 1)
    return DecodeSlots(rows=torch.arange(pos.shape[0], device=pos.device),
                       slot=slot, valid=valid)


def cache_positions(cfg: ModelConfig, cache_len: int,
                    pos: torch.Tensor) -> torch.Tensor:
    """valid-slot mask for a decode step at absolute position ``pos``
    (number of tokens already in cache). Handles ring-buffer windows."""
    idx = torch.arange(cache_len, device=pos.device)
    if cfg.attention_window:
        # slots hold absolute positions pos-1, pos-2, ... (wrapped); a slot
        # i is valid if it has been written: i < pos (before wrap) or
        # always after the buffer has wrapped once.
        return idx[None, :] < torch.clamp(pos, max=cache_len)[:, None]
    return idx[None, :] < pos[:, None]


# ---------------------------------------------------------------------------
# Attention forward: full-sequence (prefill) and decode step
# ---------------------------------------------------------------------------

def attention_forward(p, cfg: ModelConfig, x: torch.Tensor,
                      rope: Optional[RopeTables], *,
                      num_kv: Optional[int] = None,
                      window: int = 0,
                      cache_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, KVCache]:
    """Causal self-attention over a whole sequence. Returns output and the
    cache that a subsequent decode would consume (prefill contract).
    ``rope``: the tables of the tokens' positions (``model_rope``)."""
    num_kv = cfg.num_kv_heads if num_kv is None else num_kv
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, num_kv, kv_read=True)
    if cfg.use_rope:
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)
    if (cfg.ref_attention == "chunked" and S >= CHUNKED_ATTENTION_MIN_SEQ
            and not cfg.use_pallas):
        out = flash_attention_chunked(q, k, v, causal=True, window=window)
    elif window:
        # banded causal mask: j in (i-window, i]
        i = torch.arange(S, device=x.device)[:, None]
        j = torch.arange(S, device=x.device)[None, :]
        band = (j <= i) & (j > i - window)
        out = gqa_attention(q, k, v, band[None, None], use_pallas=False)
    else:
        out = gqa_attention(q, k, v, None, causal=True,
                            use_pallas=cfg.use_pallas)
    out = merge_dims(out, 2)
    y = matmul(out, p["wo"].to(out.dtype))
    cache = _cache_from_prefill(cfg, k, v, window, cache_len, num_kv)
    return y, cache


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``pad`` zero slots after the sequence axis (1) of a (B, S, ...)
    tensor."""
    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _cache_from_prefill(cfg: ModelConfig, k, v, window: int,
                        cache_len: Optional[int] = None,
                        num_kv: Optional[int] = None) -> KVCache:
    if window or cfg.attention_window:
        w = window or cfg.attention_window
        S = k.shape[1]
        if S >= w:
            k = k[:, S - w:]
            v = v[:, S - w:]
            # ring layout: slot (S - w + i) % w == written order; re-roll so
            # that slot j holds absolute position with j == pos % w.
            shift = (S - w) % w
            k = torch.roll(k, shift, dims=1)
            v = torch.roll(v, shift, dims=1)
        else:
            k = _pad_seq(k, w - S)
            v = _pad_seq(v, w - S)
    elif cache_len is not None and cache_len > k.shape[1]:
        pad = cache_len - k.shape[1]
        k = _pad_seq(k, pad)
        v = _pad_seq(v, pad)
    if is_dtensor(k):
        # placed as a decode cache: the heads split, or the slots
        from repro_torch.distributed import parallel
        num_kv = cfg.num_kv_heads if num_kv is None else num_kv
        k, v = (parallel.kv_cache_layout(t, num_kv) for t in (k, v))
    return KVCache(k=k, v=v)


def _write_cache(cfg: ModelConfig, cache_arr: torch.Tensor,
                 new_vals: torch.Tensor, slots: DecodeSlots) -> torch.Tensor:
    """Write each row's new token into its slot, in place. ``kv_update``
    "onehot" and "scatter" give equal values in the JAX package (the one-hot
    blend of a zero-initialised cache is exact), so both are this one slot
    write here. cache (B,T,...), new (B,1,...). A placed cache (a DTensor)
    is written shard by shard (``distributed.parallel.write_slots``)."""
    if cfg.kv_update not in ("onehot", "scatter"):
        raise ValueError(f"unknown kv_update {cfg.kv_update!r}")
    if is_dtensor(cache_arr):
        from repro_torch.distributed import parallel
        return parallel.write_slots(cache_arr, slots.slot,
                                    new_vals[:, 0].to(cache_arr.dtype))
    cache_arr[slots.rows, slots.slot] = new_vals[:, 0].to(cache_arr.dtype)
    return cache_arr


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: KVCache,
                     slots: DecodeSlots, rope: Optional[RopeTables], *,
                     num_kv: Optional[int] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B,1,d_model); ``slots``: the step's
    ``decode_slots``; ``rope``: the tables of its positions. The cache is
    written in place and returned."""
    num_kv = cfg.num_kv_heads if num_kv is None else num_kv
    q, k, v = _project_qkv(p, cfg, x, num_kv)
    if cfg.use_rope:
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)
    k_new = _write_cache(cfg, cache.k, k, slots)
    v_new = _write_cache(cfg, cache.v, v, slots)
    out = decode_attention(q, k_new, v_new, slots.valid,
                           use_pallas=cfg.use_pallas)
    out = merge_dims(out, 2)
    y = matmul(out, p["wo"].to(out.dtype))
    return y, KVCache(k=k_new, v=v_new)


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder -> encoder states)
# ---------------------------------------------------------------------------

def init_cross_attention(gen: torch.Generator, cfg: ModelConfig):
    return init_attention(gen, cfg, num_kv=cfg.num_kv_heads)


def cross_attention(p, cfg: ModelConfig, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """x: (B,S,d); enc_k/enc_v: (B,T,Hkv,D) precomputed from the encoder
    (``encoder_kv``). Only q is projected, with no qk-norm; every query
    attends to every frame through the plain ``gqa_attention``, as in the
    JAX package."""
    q = split_dim(matmul(x, p["wq"].to(x.dtype)), 2,
                  (cfg.num_heads, cfg.head_dim))
    out = merge_dims(gqa_attention(q, enc_k, enc_v, None), 2)
    return matmul(out, p["wo"].to(out.dtype))


def encoder_kv(p, cfg: ModelConfig, enc_out: torch.Tensor):
    """The cross-attention K and V of the encoder's output (B,T,d), each
    (B,T,Hkv,D)."""
    heads = (cfg.num_kv_heads, cfg.head_dim)
    k, v = matmul(enc_out, *(p[n].to(enc_out.dtype) for n in ("wk", "wv")))
    return split_dim(k, 2, heads), split_dim(v, 2, heads)


# ---------------------------------------------------------------------------
# MLA: Multi-head Latent Attention (DeepSeek-V2) with a compressed KV cache
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    """Per-layer MLA cache; a model's stacked cache holds (L, B, T, ...)
    tensors."""
    c_kv: torch.Tensor     # (B, T, kv_lora_rank) compressed latents
    k_rope: torch.Tensor   # (B, T, qk_rope_head_dim) shared rope key


def init_mla(gen: torch.Generator, cfg: ModelConfig):
    dt = cfg.weight_dtype
    H = cfg.num_heads
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {
        "wq": dense_init(gen, (cfg.d_model, H * qk_dim), dt),
        "w_dkv": dense_init(
            gen, (cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim), dt),
        "kv_norm": torch.ones((cfg.kv_lora_rank,), dtype=dt,
                              device=gen.device),
        "w_uk": dense_init(gen, (cfg.kv_lora_rank,
                                 H * cfg.qk_nope_head_dim), dt),
        "w_uv": dense_init(gen, (cfg.kv_lora_rank, H * cfg.v_head_dim), dt),
        "wo": dense_init(gen, (H * cfg.v_head_dim, cfg.d_model), dt),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device="cuda") -> MLACache:
    dt = cfg.activation_dtype
    return MLACache(
        c_kv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dt,
                         device=device),
        k_rope=torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dt,
                           device=device))


def _mla_qkv(p, cfg: ModelConfig, x: torch.Tensor, rope: RopeTables):
    """Project q (nope and rope parts) and the compressed kv latents. The
    latents' norm is the plain RMSNorm, as in the JAX package."""
    B, S, _ = x.shape
    H = cfg.num_heads
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    q = split_dim(matmul(x, p["wq"].to(x.dtype)), 2, (H, qk_dim))
    q_nope, q_rope = torch.split(
        q, [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, rope)
    ckv = matmul(x, p["w_dkv"].to(x.dtype))               # (B,S,rank+rope)
    c_kv, k_rope = torch.split(
        ckv, [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], rope)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_up(p, cfg: ModelConfig, c_kv: torch.Tensor):
    """K (nope part) and V of every latent: (B,T,H,nope), (B,T,H,v)."""
    H = cfg.num_heads
    k_nope, v = matmul(c_kv, *(p[n].to(c_kv.dtype)
                               for n in ("w_uk", "w_uv")))
    k_nope = split_dim(k_nope, 2, (H, cfg.qk_nope_head_dim))
    v = split_dim(v, 2, (H, cfg.v_head_dim))
    return k_nope, v


def _mla_attend(p, cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope,
                mask: torch.Tensor) -> torch.Tensor:
    """Attention over (possibly cached) latents, up-projecting K and V of
    every latent as the JAX package does. ``mask`` broadcasts to
    (B, H, S, T)."""
    k_nope, v = _mla_up(p, cfg, c_kv)
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if is_dtensor(q_nope):
        from repro_torch.distributed import parallel
        out = parallel.local_heads(_mla_scores, (q_nope, q_rope, k_nope, v),
                                   k_rope, mask, scale, partial=_mla_partial)
    else:
        out = _mla_scores(q_nope, q_rope, k_nope, v, k_rope, mask, scale)
    out = merge_dims(out, 2).to(q_nope.dtype)
    return matmul(out, p["wo"].to(out.dtype))


def _mla_logits(q_nope, q_rope, k_nope, k_rope, mask, scale):
    """MLA's masked fp32 scores (B,H,S,T): q_nope (B,S,H,nope) against
    k_nope (B,T,H,nope) plus q_rope (B,S,H,rope) against the shared k_rope
    (B,T,rope)."""
    s_nope = torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
    s_rope = torch.einsum("bshd,btd->bhst", q_rope.float(), k_rope.float())
    scores = (s_nope + s_rope) * scale
    return torch.where(mask, scores, NEG_INF)


def _mla_scores(q_nope, q_rope, k_nope, v, k_rope, mask, scale):
    """MLA's softmax attention over v (B,T,H,v): (B,S,H,v) fp32."""
    probs = torch.softmax(
        _mla_logits(q_nope, q_rope, k_nope, k_rope, mask, scale), dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, v.float())


def _mla_partial(q_nope, q_rope, k_nope, v, k_rope, mask, scale):
    """``_mla_scores`` over one part of the keys (``_softmax_parts``): m
    and l (B,H,S), acc (B,H,S,v)."""
    return _softmax_parts(
        _mla_logits(q_nope, q_rope, k_nope, k_rope, mask, scale), v,
        "bhst,bthd->bhsd")


def _mla_chunked(q_nope, q_rope, k_nope, v, k_rope, mask):
    """Flash-style MLA attention: (nope, rope) concatenated into one key
    space so that the chunked streaming softmax applies; (B,S,H,v). The
    mask is None: the chunked path is causal by position."""
    B, T, H = k_nope.shape[:3]
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, T, H, k_rope.shape[-1])], dim=-1)
    return flash_attention_chunked(q_cat, k_cat, v, causal=True)


def _mla_attend_chunked(p, cfg: ModelConfig, q_nope, q_rope, c_kv,
                        k_rope) -> torch.Tensor:
    """``_mla_chunked`` over every latent's K and V; placed operands attend
    on each rank's heads (``distributed.parallel.local_heads``)."""
    k_nope, v = _mla_up(p, cfg, c_kv)
    if is_dtensor(q_nope):
        from repro_torch.distributed import parallel
        out = parallel.local_heads(_mla_chunked, (q_nope, q_rope, k_nope, v),
                                   k_rope, None)
    else:
        out = _mla_chunked(q_nope, q_rope, k_nope, v, k_rope, None)
    out = merge_dims(out, 2)
    return matmul(out, p["wo"].to(out.dtype))


def mla_forward(p, cfg: ModelConfig, x: torch.Tensor, rope: RopeTables,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, MLACache]:
    """Causal MLA over a whole sequence; returns the output and the latent
    cache a decode would consume. ``rope``: the tables of the tokens'
    positions at ``qk_rope_head_dim`` (``model_rope``)."""
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, rope)
    if (cfg.ref_attention == "chunked"
            and S >= CHUNKED_ATTENTION_MIN_SEQ):
        y = _mla_attend_chunked(p, cfg, q_nope, q_rope, c_kv, k_rope)
    else:
        causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                       device=x.device))[None, None]
        y = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, causal)
    if cache_len is not None and cache_len > S:
        c_kv = _pad_seq(c_kv, cache_len - S)
        k_rope = _pad_seq(k_rope, cache_len - S)
    if is_dtensor(c_kv):
        # placed as a decode cache: the latents split over their rank
        from repro_torch.distributed import parallel
        c_kv = parallel.cache_layout(c_kv, 2)
    return y, MLACache(c_kv=c_kv, k_rope=k_rope)


def _mla_absorbed(p, cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope,
                  valid: torch.Tensor) -> torch.Tensor:
    """One token's MLA in the latent space (DeepSeek-V2's absorption,
    arXiv:2405.04434, section 2.1.2): ``w_uk`` taken into each head's
    query and ``w_uv`` into its output, so every head attends to the cached
    latents as they are, one key (R + rope wide) and value (R) they all
    share. The same sum as ``_mla_attend``'s, with no latent up-projected.
    q_nope (B,1,H,nope), q_rope (B,1,H,rope); c_kv (B,T,R); k_rope
    (B,T,rope); valid (B,T). ``cfg.use_pallas`` attends through the kernel
    (``kernels.mla_decode``), else through its plain version."""
    B, _, H, _ = q_nope.shape
    R = cfg.kv_lora_rank
    w_uk = p["w_uk"].to(q_nope.dtype).view(R, H, cfg.qk_nope_head_dim)
    w_uv = p["w_uv"].to(q_nope.dtype).view(R, H, cfg.v_head_dim)
    # (H, B, nope) @ (H, nope, R), then the rope part: (B, H, R + rope)
    q_lat = torch.matmul(q_nope[:, 0].transpose(0, 1), w_uk.permute(1, 2, 0))
    q = torch.cat([q_lat, q_rope[:, 0].transpose(0, 1)], dim=-1)
    q = q.transpose(0, 1)
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.use_pallas:
        from repro_torch.kernels import ops as kops
        o_lat = kops.mla_decode(q, c_kv, k_rope, valid, scale)
    else:
        from repro_torch.kernels import ref
        o_lat = ref.mla_decode(q, c_kv, k_rope, valid, scale)
    # (H, B, R) @ (H, R, v): each head's output from its latent one
    out = torch.matmul(o_lat.transpose(0, 1), w_uv.permute(1, 0, 2))
    out = out.transpose(0, 1).reshape(B, 1, H * cfg.v_head_dim)
    return matmul(out, p["wo"].to(out.dtype))


def mla_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: MLACache,
               slots: DecodeSlots, rope: RopeTables
               ) -> Tuple[torch.Tensor, MLACache]:
    """One-token MLA decode. x: (B,1,d_model); ``slots``: the step's
    ``decode_slots`` (no window: MLA's cache is never a ring); ``rope``:
    the tables of its positions. The new latent and rope key are written
    into the cache in place, which is returned. Attention runs in the
    latent space (``_mla_absorbed``); placed operands (DTensors) keep the
    up-projected form, each rank on its heads (``_mla_attend``)."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, rope)
    c_new = _write_cache(cfg, cache.c_kv, c_kv, slots)
    kr_new = _write_cache(cfg, cache.k_rope, k_rope, slots)
    if not (is_dtensor(q_nope) or is_dtensor(c_new)):
        y = _mla_absorbed(p, cfg, q_nope, q_rope, c_new, kr_new,
                          slots.valid)
        return y, MLACache(c_kv=c_new, k_rope=kr_new)
    c_att, kr_att, valid = c_new, kr_new, slots.valid[:, None, None]
    if is_dtensor(c_new):
        # where the data axes leave the batch whole, each of their ranks
        # attends a part of the slots
        from repro_torch.distributed import parallel
        c_att, kr_att, valid = parallel.split_slots(
            q_nope, (c_att, 1), (kr_att, 1), (valid, -1))
    y = _mla_attend(p, cfg, q_nope, q_rope, c_att, kr_att, valid)
    return y, MLACache(c_kv=c_new, k_rope=kr_new)
