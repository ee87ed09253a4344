"""RMSNorm: the Triton kernel for Hopper, its plain version and its count.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm_kernel``: per row, the
fp32 mean of squares, ``rsqrt(var + eps)``, times the weight, cast back to
the input dtype.

What bounds it on the H100: bytes, one read of x and one write of the
output. On the serving path x is (R, 3072) bf16 with R = 8 at decode and
R <= 64 at prefill: under 1 MB, a fraction of a microsecond at 3.35 TB/s,
so each of the 57 calls per step is bound by its launch. The design: one
program per row (no row padding, unlike the Pallas grid's blocks of 256),
the row held whole in one power-of-two block (4096 for D = 3072) under a
mask, the sum taken in fp32 in registers.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels._build import use_kernel
from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain

__all__ = ["rmsnorm", "rmsnorm_plain"]


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    """Define the Triton kernel; triton is imported only here, at first
    launch (it is absent where the plain version runs)."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def _rmsnorm_row(x_ptr, w_ptr, o_ptr, D, stride_x, stride_o, eps,
                     BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < D
        x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                    other=0.0).to(tl.float32)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / D
        y = x * tl.rsqrt(var + eps) * w
        tl.store(o_ptr + row * stride_o + cols,
                 y.to(o_ptr.dtype.element_ty), mask=mask)

    return triton, _rmsnorm_row


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); weight: (D,). On a CUDA tensor launches the Triton
    kernel, on a CPU tensor runs the plain version."""
    if not use_kernel(x):
        return rmsnorm_plain(x, weight, eps=eps)
    D = x.shape[-1]
    if weight.shape != (D,) or weight.device != x.device:
        raise ValueError("rmsnorm: weight must be (D,) on x's device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm: unsupported dtype {x.dtype}")
    x2 = x.reshape(-1, D)
    if x2.stride(-1) != 1:
        raise ValueError("rmsnorm: the last dim of x must be contiguous")
    out = torch.empty((x2.shape[0], D), dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        triton, kernel = _triton_kernel()
        block = triton.next_power_of_2(D)
        kernel[(x2.shape[0],)](x2, weight.contiguous(), out, D,
                               x2.stride(0), out.stride(0), float(eps),
                               BLOCK=block, num_warps=8 if block >= 2048
                               else 4)
        rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0
