"""RMSNorm, alone or with the residual add before it: the CUDA kernel's
wrappers, their plain versions and their counts. The kernel and its design
note are in ``repro_torch/csrc/rmsnorm.cu``; it replaces
``src/repro/kernels/rmsnorm.py::rmsnorm_kernel``.

What bounds it on the H100: its launch. On the serving path x is
(R, d_model) with R = 8 at decode and R <= 64 at prefill, under 1 MB, a
fraction of a microsecond at 3.35 TB/s. So the models hand each residual
add to the norm after it (``add_rmsnorm``), which saves the add's launch and
a round trip of the residual through memory.

``rmsnorm.launches`` counts every launch of the kernel, fused or not (one per
norm); ``rmsnorm.fused_launches`` counts those of ``add_rmsnorm`` among them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import add_rmsnorm as add_rmsnorm_plain
from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain

__all__ = ["rmsnorm", "add_rmsnorm", "rmsnorm_plain", "add_rmsnorm_plain"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # ReproDType in common.cuh
PALLAS = "rmsnorm_kernel"


def _lib():
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 2 + [_L] * 2 + [_I] * 2 + \
            [ctypes.c_float, _P]
        fn.restype = _I
    return lib


def _rows(t: torch.Tensor, D: int):
    """(t or its (rows, D) view, row stride); the last dim must be
    contiguous. A contiguous t is passed as it is (no reshape)."""
    if t.is_contiguous():
        return t, D
    t2 = t.reshape(-1, D)
    if t2.stride(-1) != 1:
        raise ValueError("rmsnorm: the last dim of x must be contiguous")
    return t2, t2.stride(0)


def _launch(x: torch.Tensor, r: Optional[torch.Tensor], weight: torch.Tensor,
            eps: float):
    """(s or None, y) from the kernel; s = x + r when r is given. The host
    path is kept short: the decode step launches this once per norm."""
    D = x.shape[-1]
    if weight.shape != (D,) or weight.device != x.device:
        raise ValueError("rmsnorm: weight must be (D,) on x's device")
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: unsupported dtype {x.dtype} (weight "
                        f"{weight.dtype})")
    if r is not None and (r.shape != x.shape or r.dtype != x.dtype
                          or r.device != x.device):
        raise ValueError("add_rmsnorm: r must match x in shape, dtype and "
                         "device")
    x2, sx = _rows(x, D)
    r2, sr = (None, 0) if r is None else _rows(r, D)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    s = None if r is None else torch.empty_like(y)
    rows = x.numel() // D if D else 0
    if rows:
        w = weight.contiguous()
        lib = _lib()
        rc = lib.rmsnorm_fwd(
            x2.data_ptr(), None if r2 is None else r2.data_ptr(),
            w.data_ptr(), None if s is None else s.data_ptr(), y.data_ptr(),
            rows, D, sx, sr, _DTYPES[x.dtype], _DTYPES[w.dtype], eps,
            _build.stream_ptr(x))
        _build.check(lib, rc, "rmsnorm")
        rmsnorm.launches += 1
        if r is not None:
            rmsnorm.fused_launches += 1
    return s, y


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); weight: (D,). On a CUDA tensor launches the kernel, on a
    CPU tensor runs the plain version."""
    _build.refuse_grad("rmsnorm", PALLAS, x, weight)
    if not _build.use_kernel(x):
        return rmsnorm_plain(x, weight, eps=eps)
    return _launch(x, None, weight, eps)[1]


def add_rmsnorm(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, *,
                eps: float = 1e-6):
    """(s, y) with s = x + r in x's dtype, rounded as the add rounds, and
    y = rmsnorm(s, weight). x, r: (..., D) of one dtype; weight: (D,). On a
    CUDA tensor launches the kernel, on a CPU tensor runs the plain
    version."""
    _build.refuse_grad("add_rmsnorm", PALLAS, x, r, weight)
    if not _build.use_kernel(x):
        return add_rmsnorm_plain(x, r, weight, eps=eps)
    return _launch(x, r, weight, eps)


rmsnorm.launches = 0
rmsnorm.fused_launches = 0
