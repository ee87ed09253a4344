"""GQA attention of the port: prefill and decode, the KV cache and its
sliding-window ring buffer. Plain paths are PyTorch; with ``cfg.use_pallas``
the hand-written Hopper kernels of ``repro_torch.kernels`` run instead (on
a CPU tensor their plain versions run). MLA, cross-attention and the
chunked reference path (``ref_attention="chunked"``) of
``repro.models.attention`` are not ported yet and raise.

The decode cache is updated in place: ``attention_decode`` writes the new
token's K/V into the cache tensors it was given and returns them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import (ModelConfig, apply_rope, dense_init,
                                       rms_norm)

NEG_INF = -1e30

# threshold above which ``ref_attention="chunked"`` would switch the plain
# path to the streaming reference (not ported)
CHUNKED_ATTENTION_MIN_SEQ = 1024


# ---------------------------------------------------------------------------
# Core scaled-dot-product helpers (plain paths)
# ---------------------------------------------------------------------------

def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], *,
                  causal: bool = False,
                  use_pallas: bool = False) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,Hkv,D); mask: broadcastable (B,1,S,T) bool.

    Grouped-query: H = G*Hkv query heads share each kv head.
    """
    if use_pallas and causal and mask is None and q.shape[1] == k.shape[1]:
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=True)
    B, S, H, D = q.shape
    T = k.shape[1]
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) * (D ** -0.5)
    if causal:
        cm = torch.tril(torch.ones((S, T), dtype=torch.bool,
                                   device=q.device), diagonal=T - S)
        scores = torch.where(cm, scores, NEG_INF)
    if mask is not None:
        m = mask[:, :, None] if mask.ndim == 4 else mask
        scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


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


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor, num_kv: int):
    B, S, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, num_kv, cfg.head_dim)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, num_kv, cfg.head_dim)
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
                      positions: torch.Tensor, *,
                      num_kv: Optional[int] = None,
                      window: int = 0,
                      cache_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, KVCache]:
    """Causal self-attention over a whole sequence. Returns output and the
    cache that a subsequent decode would consume (prefill contract)."""
    num_kv = cfg.num_kv_heads if num_kv is None else num_kv
    B, S, _ = x.shape
    if (cfg.ref_attention == "chunked" and S >= CHUNKED_ATTENTION_MIN_SEQ
            and not cfg.use_pallas):
        raise NotImplementedError(
            "ref_attention='chunked' (the streaming reference of "
            "repro.models.attention.flash_attention_jnp) is not ported yet")
    q, k, v = _project_qkv(p, cfg, x, num_kv)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if window:
        # banded causal mask: j in (i-window, i]
        i = torch.arange(S, device=x.device)[:, None]
        j = torch.arange(S, device=x.device)[None, :]
        band = (j <= i) & (j > i - window)
        out = gqa_attention(q, k, v, band[None, None], use_pallas=False)
    else:
        out = gqa_attention(q, k, v, None, causal=True,
                            use_pallas=cfg.use_pallas)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    y = out @ p["wo"].to(out.dtype)
    cache = _cache_from_prefill(cfg, k, v, window, cache_len)
    return y, cache


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))


def _cache_from_prefill(cfg: ModelConfig, k, v, window: int,
                        cache_len: Optional[int] = None) -> KVCache:
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
    return KVCache(k=k, v=v)


def _write_cache(cfg: ModelConfig, cache_arr: torch.Tensor,
                 new_vals: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Write each row's new token into its slot, in place. ``kv_update``
    "onehot" and "scatter" give equal values in the JAX package (the one-hot
    blend of a zero-initialised cache is exact), so both are this one slot
    write here. cache (B,T,...), new (B,1,...), slot (B,)."""
    if cfg.kv_update not in ("onehot", "scatter"):
        raise ValueError(f"unknown kv_update {cfg.kv_update!r}")
    rows = torch.arange(cache_arr.shape[0], device=cache_arr.device)
    cache_arr[rows, slot] = new_vals[:, 0].to(cache_arr.dtype)
    return cache_arr


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: KVCache,
                     pos: torch.Tensor, *,
                     num_kv: Optional[int] = None,
                     window: int = 0) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B,1,d_model); pos: (B,) tokens-so-far. The
    cache is written in place and returned."""
    num_kv = cfg.num_kv_heads if num_kv is None else num_kv
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, num_kv)
    if cfg.use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    w = window or cfg.attention_window
    cache_len = cache.k.shape[1]
    slot = (torch.remainder(pos, cache_len) if w
            else torch.clamp(pos, max=cache_len - 1))
    k_new = _write_cache(cfg, cache.k, k, slot)
    v_new = _write_cache(cfg, cache.v, v, slot)
    valid = cache_positions(cfg.replace(attention_window=w), cache_len,
                            pos + 1)
    out = decode_attention(q, k_new, v_new, valid,
                           use_pallas=cfg.use_pallas)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    y = out @ p["wo"].to(out.dtype)
    return y, KVCache(k=k_new, v=v_new)
