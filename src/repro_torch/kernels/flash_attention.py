"""Causal GQA flash attention for prefill: the CUDA kernel's wrapper, its
plain version and its count. The kernel and its design note are in
``repro_torch/csrc/flash_attention.cu``; it replaces
``src/repro/kernels/flash_attention.py::flash_attention_bhsd``.

What bounds it on the H100: at the serving path's prefill shapes (B = 1,
S <= 64, 24 query heads over 8 kv heads, D = 128, bf16) its bytes take
under a microsecond, so each of the 28 calls per forward is bound by its
launch. The kernel reads q, k and v through their (B, S, H, D) strides,
with no transposed copy, and skips KV tiles wholly above the diagonal.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention as flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 6 + [_L] * 12 + [_F, _I, _P]
        fn.restype = _I
    return lib


def _check(q, k, v):
    B, S, H, D = q.shape
    if k.shape != (B, S, k.shape[2], D) or v.shape != k.shape:
        raise ValueError("flash_attention: q (B,S,H,D), k/v (B,S,Hkv,D)")
    if H % k.shape[2]:
        raise ValueError("flash_attention: H must be a multiple of Hkv")
    if D not in (64, 128):
        raise ValueError(f"flash_attention: head_dim {D} not in (64, 128)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    for t in (q, k, v):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError("flash_attention: tensors on one device, "
                             "with a unit head_dim stride")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,S,Hkv,D) -> (B,S,H,D). On a CUDA tensor
    launches the kernel, on a CPU tensor runs the plain version."""
    if not _build.use_kernel(q):
        return flash_attention_plain(q, k, v, causal=causal)
    _check(q, k, v)
    B, S, H, D = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _lib()
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], B, S, H, k.shape[2], D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        D ** -0.5, int(causal), _build.stream_ptr(q))
    _build.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
