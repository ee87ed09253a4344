"""Mamba-2's recurrent decode step: the CUDA kernel's wrapper, its plain
version and its count. The kernel and its design note are in
``repro_torch/csrc/ssd_step.cu``. It replaces no Pallas kernel: the JAX
package steps the state in plain jnp (``repro/models/blocks.py``
``ssd_block_forward``, its S == 1 branch), and so did the port, in six
PyTorch passes over the fp32 state. Its caller is
``models/blocks.py`` ``_ssd_heads``.

What bounds it on the H100: the state's bytes, read once and written once
(B x H x P x N fp32 each way; 268 MB a layer of mamba2-1.3b at batch 64,
80 us at 3.35 TB/s). The kernel streams it once, the update rounded as the
plain step rounds it, so the new state equals the plain step's bit for
bit; y's sum over N runs in another order. It captures into a CUDA graph:
it allocates nothing but its output through PyTorch, and does not
synchronise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_step as ssd_step_plain

__all__ = ["ssd_step", "ssd_step_plain"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the state widths N the kernel is built for
WIDTHS = (16, 32, 64, 128, 256)


def _lib():
    lib = _build.load("ssd_step")
    fn = lib.ssd_step_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 5 + [_L] * 12 + [_P]
        fn.restype = _I
    return lib


def _check(x, dt, A, B, C, D, state):
    """What the function takes, on every device."""
    b, h, p = x.shape
    g, n = B.shape[1], B.shape[2]
    if dt.shape != (b, h) or A.shape != (h,) or D.shape != (h,) or \
            B.shape != (b, g, n) or C.shape != B.shape or \
            state.shape != (b, h, p, n):
        raise ValueError("ssd_step: x (b,h,p), dt (b,h), A (h,), B/C "
                         "(b,g,n), D (h,), state (b,h,p,n)")
    if h % g:
        raise ValueError("ssd_step: heads must be a multiple of groups")
    for t in (x, dt, A, B, C, D, state):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_step: fp32 inputs only, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("ssd_step: tensors on one device")


def _check_kernel(x, dt, A, B, C, D, state):
    """What the kernel takes besides: its widths, unit last strides, and
    16-byte state rows."""
    if state.shape[-1] not in WIDTHS:
        raise ValueError(f"ssd_step: N must be one of {WIDTHS}, not "
                         f"{state.shape[-1]}")
    for t in (x, dt, A, B, C, D, state):
        if t.stride(-1) != 1:
            raise ValueError("ssd_step: every operand needs a unit stride "
                             "on its last dim")
    if state.data_ptr() % 16 or any(s % 4 for s in state.stride()[:3]):
        raise ValueError("ssd_step: the state's rows must be 16-byte "
                         "aligned")


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             state: torch.Tensor) -> torch.Tensor:
    """x (b,h,p); dt (b,h), after the softplus; A (h,), exp(A_log); B, C
    (b,g,n); D (h,); state (b,h,p,n), all fp32 -> y (b,h,p), with
    ``state`` updated in place (``ssd_step_plain``). A CPU tensor runs the
    plain version, a CUDA tensor launches the kernel; the operands' shapes
    and dtypes are checked on both, the kernel's own limits on the card."""
    _build.refuse_grad("ssd_step", None, x, dt, A, B, C, D, state)
    _check(x, dt, A, B, C, D, state)
    if not _build.use_kernel(x):
        return ssd_step_plain(x, dt, A, B, C, D, state)
    _check_kernel(x, dt, A, B, C, D, state)
    b, h, p = x.shape
    g, n = B.shape[1], B.shape[2]
    y = torch.empty((b, h, p), dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.ssd_step_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), state.data_ptr(), y.data_ptr(), b, h, p,
        n, g, x.stride(0), x.stride(1), dt.stride(0), B.stride(0),
        B.stride(1), C.stride(0), C.stride(1), state.stride(0),
        state.stride(1), state.stride(2), y.stride(0), y.stride(1),
        _build.stream_ptr(x))
    _build.check(lib, rc, "ssd_step")
    ssd_step.launches += 1
    return y


ssd_step.launches = 0
