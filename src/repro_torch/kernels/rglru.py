"""RG-LRU linear recurrence: the CUDA kernel's wrapper, its plain version
and its count. The kernel and its design note are in
``repro_torch/csrc/rglru_scan.cu``; it replaces
``src/repro/kernels/rglru.py::rglru_scan_kernel``.

What bounds it on the H100: bytes (read x and log_a, write y). One thread
per (batch, width) lane walks time in registers, with loads coalesced
along the width; the kernel picks its own tiles, so the ``block_w`` and
``block_s`` of the Pallas kernel are not taken.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan as rglru_scan_plain

__all__ = ["rglru_scan", "rglru_scan_plain"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 3 + [_L] * 5 + [_P]
        fn.restype = _I
    return lib


def _check(x, log_a, h0):
    B, S, W = x.shape
    if log_a.shape != (B, S, W) or h0.shape != (B, W):
        raise ValueError("rglru_scan: x, log_a (B,S,W), h0 (B,W)")
    for t in (x, log_a, h0):
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan: fp32 inputs only, got {t.dtype}")
        if t.device != x.device or t.stride(-1) != 1:
            raise ValueError("rglru_scan: tensors on one device, with a "
                             "unit W stride")


def rglru_scan(x: torch.Tensor, log_a: torch.Tensor, h0: torch.Tensor):
    """x, log_a (B,S,W); h0 (B,W), all fp32 -> (ys (B,S,W), h_last (B,W))
    fp32. On a CUDA tensor launches the kernel, on a CPU tensor runs the
    plain version."""
    if not _build.use_kernel(x):
        return rglru_scan_plain(x, log_a, h0)
    _check(x, log_a, h0)
    B, S, W = x.shape
    ys = torch.empty((B, S, W), dtype=torch.float32, device=x.device)
    h_last = torch.empty((B, W), dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.rglru_scan_fwd(
        x.data_ptr(), log_a.data_ptr(), h0.data_ptr(), ys.data_ptr(),
        h_last.data_ptr(), B, S, W, x.stride(0), x.stride(1),
        log_a.stride(0), log_a.stride(1), h0.stride(0),
        _build.stream_ptr(x))
    _build.check(lib, rc, "rglru_scan")
    rglru_scan.launches += 1
    return ys, h_last


rglru_scan.launches = 0
