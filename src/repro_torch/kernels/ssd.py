"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper, its plain version
and its count. The kernel and its design note are in
``repro_torch/csrc/ssd_scan.cu``; it replaces
``src/repro/kernels/ssd.py::ssd_scan_kernel``.

What bounds it on the H100: operations over a long prompt, in fp32 on the
CUDA cores (the model holds it to 2e-4, so no TF32); at a 64-token prompt
in one chunk, the bytes it moves and the products it needs take about as
long. One block per (batch, head) walks the
chunks in order with the (P, N) state in shared memory. B and C are read
through their strides, group ``h // (H / G)`` for head ``h``, so the
grouped layout is never repeated per head, and x is read in place from the
fused projection it was split from.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan as ssd_scan_plain

__all__ = ["ssd_scan", "ssd_scan_plain"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
CHUNK_MAX = 128


def _lib():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 7 + [_L] * 12 + [_P]
        fn.restype = _I
    return lib


def _check(x, dt, A, B, C, chunk):
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if dt.shape != (b, s, h) or A.shape != (h,) or \
            B.shape != (b, s, g, n) or C.shape != B.shape:
        raise ValueError("ssd_scan: x (b,s,h,p), dt (b,s,h), A (h,), "
                         "B/C (b,s,g,n)")
    if h % g:
        raise ValueError("ssd_scan: heads must be a multiple of groups")
    if chunk < 1 or chunk > CHUNK_MAX or chunk & (chunk - 1) or s % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} must be a power of two "
                         f"<= {CHUNK_MAX} that divides s = {s}")
    for t in (x, dt, A, B, C):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: fp32 inputs only, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("ssd_scan: tensors on one device")
    for t in (x, B, C, A):
        if t.stride(-1) != 1:
            raise ValueError("ssd_scan: x, B, C and A need a unit stride "
                             "on their last dim")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int):
    """x (b,s,h,p); dt (b,s,h); A (h,); B,C (b,s,g,n), all fp32 ->
    (y (b,s,h,p), final_state (b,h,p,n)) fp32, from a zero state. On a
    CUDA tensor launches the kernel, on a CPU tensor runs the plain
    version."""
    if not _build.use_kernel(x):
        return ssd_scan_plain(x, dt, A, B, C)
    _check(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, h, p, g, n,
        chunk, *x.stride()[:3], *dt.stride(), *B.stride()[:3],
        *C.stride()[:3], _build.stream_ptr(x))
    _build.check(lib, rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
