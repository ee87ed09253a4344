"""Flash-decoding against the KV cache: the CUDA kernel's wrapper, its
plain version and its count. The kernel and its design note are in
``repro_torch/csrc/decode_attention.cu``; it replaces
``src/repro/kernels/decode_attention.py::decode_attention_grouped``.

What bounds it on the H100: the bytes of the cache's valid slots. The
kernel reads the (B, T, Hkv, D) cache through its strides; the reference
wrapper's transposed copy (``repro/kernels/ops.py``) would move
2 x 33.5 MB per layer per step at B = 8, T = 2048 in bf16. The first
pass splits T into chunks (``split_plan``: fp32, ``split_plan_mma``:
bf16); the second merges them. A row with no valid slot gives 0, as the
TPU kernel does. In bf16 the G <= 16 query heads of a kv head are the
rows of one tensor-core tile, so a block reads its chunk of the cache once
for all of them, and 16-slot tiles with no valid slot are never loaded.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention as \
    decode_attention_plain

__all__ = ["decode_attention", "decode_attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
GMAX = 16       # most query heads per kv head the kernel takes
HEAD_DIMS = (64, 128, 256)
SPLIT = 128     # fp32: slots per block of the first pass, a multiple
MMA_SPLIT = 64  # bf16: slots per block, a multiple (one stage of the ring)
MMA_CHUNK_MAX = 1024   # bf16: most slots per block


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 8 + [_L] * 11 + [_F, _P]
        fn.restype = _I
    return lib


def _check(q, k_cache, v_cache, valid):
    B, one, H, D = q.shape
    _, T, Hkv, _ = k_cache.shape
    if one != 1 or k_cache.shape != (B, T, Hkv, D) or \
            v_cache.shape != k_cache.shape or valid.shape != (B, T):
        raise ValueError("decode_attention: q (B,1,H,D), caches "
                         "(B,T,Hkv,D), valid (B,T)")
    if H % Hkv or H // Hkv > GMAX:
        raise ValueError(f"decode_attention: H/Hkv must be an integer "
                         f"<= {GMAX}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: unsupported dtype {q.dtype}")
    if valid.dtype != torch.bool or valid.stride(-1) != 1:
        raise TypeError("decode_attention: valid must be bool with a unit "
                        "T stride")
    esize = q.element_size()
    for t in (q, k_cache, v_cache, valid):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError("decode_attention: tensors on one device, "
                             "with a unit last-dim stride")
    for c in (k_cache, v_cache):
        if c.data_ptr() % 16 or any((s * esize) % 16 for s in c.stride()[:3]):
            raise ValueError("decode_attention: cache rows must be 16-byte "
                             "aligned")


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(rows: int, T: int, num_sms: int):
    """(chunk, nsplit): split each of the ``rows`` = B * Hkv sequences of T
    slots into chunks of a multiple of SPLIT slots, enough of them for
    about four blocks per SM."""
    want = max(1, -(-4 * num_sms // rows))
    nsplit = min(want, -(-T // SPLIT))
    chunk = -(-T // nsplit)
    chunk = -(-chunk // SPLIT) * SPLIT
    return chunk, -(-T // chunk)


def split_plan_mma(rows: int, T: int, num_sms: int, D: int):
    """(chunk, nsplit) of the bf16 kernel: chunks of a multiple of
    MMA_SPLIT slots, at most MMA_CHUNK_MAX, about four blocks per SM at
    head_dim 64 or 128 (three fit an SM's shared memory, and a prefix
    cache leaves some blocks without a valid slot) and one at 256 (one
    fits). On the H100 this picks the fastest chunk that
    ``tools/tune_attention.py`` times at both decode shapes of the serving
    path."""
    want = max(1, -(-(1 if D >= 256 else 4) * num_sms // rows))
    chunk = -(-T // want)
    chunk = min(MMA_CHUNK_MAX, -(-chunk // MMA_SPLIT) * MMA_SPLIT)
    return chunk, -(-T // chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q: (B,1,H,D); caches (B,T,Hkv,D); valid (B,T) bool -> (B,1,H,D).
    On a CUDA tensor launches the kernel, on a CPU tensor runs the plain
    version."""
    _build.refuse_grad("decode_attention", "decode_attention_grouped", q,
                       k_cache, v_cache)
    if not _build.use_kernel(q):
        return decode_attention_plain(q, k_cache, v_cache, valid)
    _check(q, k_cache, v_cache, valid)
    B, _, H, D = q.shape
    _, T, Hkv, _ = k_cache.shape
    sms = _num_sms(q.device.index or 0)
    chunk, nsplit = (split_plan(B * Hkv, T, sms) if q.dtype == torch.float32
                     else split_plan_mma(B * Hkv, T, sms, D))
    o = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    part = torch.empty(B * Hkv * nsplit * (H // Hkv) * (D + 2),
                       dtype=torch.float32, device=q.device)
    lib = _lib()
    rc = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        valid.data_ptr(), o.data_ptr(), part.data_ptr(), _DTYPES[q.dtype],
        B, T, H, Hkv, D, chunk, nsplit,
        q.stride(0), q.stride(2), *k_cache.stride()[:3],
        *v_cache.stride()[:3], valid.stride(0), o.stride(0), o.stride(2),
        D ** -0.5, _build.stream_ptr(q))
    _build.check(lib, rc, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
