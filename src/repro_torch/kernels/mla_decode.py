"""MLA decode in the latent space: the CUDA kernel's wrapper, its plain
version and its count. The kernel and its design note are in
``repro_torch/csrc/mla_decode.cu``. It replaces no Pallas kernel: the
JAX package attends MLA's decode through einsums over up-projected keys
and values, and so did the port (``models/attention.py`` ``_mla_up`` and
the fp32 casts of ``_mla_logits`` and ``_mla_scores``), writing and
reading K and V of every cached latent, in bf16 and again in fp32, each
layer. Its caller (``models/attention.py`` ``_mla_absorbed``) takes
``w_uk`` into the query and ``w_uv`` into the output, so the kernel reads
the cached latents as they are.

What bounds it on the H100: the bytes of the valid latent rows, each read
once for all heads, as key and as value (75.5 MB a layer for 32 rows of
2048 slots of 512 + 64 bf16; 23 us at 3.35 TB/s). A listing pass lists
each row's 16-slot tiles that hold a valid slot (the others are never
read); the first pass cuts the batch's listed tiles into ``grid_plan``
equal runs, one a block, so rows of any context share the card evenly;
the second merges each row's partials. It captures into a CUDA graph: it
allocates nothing but its output and scratch through PyTorch, and does
not synchronise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mla_decode as mla_decode_plain

__all__ = ["grid_plan", "mla_decode", "mla_decode_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # ReproDType in common.cuh
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
HMAX = 16                    # most heads: one MMA tile's rows
TMAX = 32768                 # most slots a row
BMAX = 1024                  # most rows
TILE = 16                    # slots a tile
MAXT = 64                    # most tiles a block takes
GMAX = 4096                  # most blocks (the merge holds 2 floats each)
BF16_WIDTHS = ((512, 64), (64, 16))   # (R, RP) the bf16 kernel is built for
F32_RMAX, F32_DKMAX = 512, 576
#: blocks of the first pass per SM: the bf16 block takes 207 KB of shared
#: memory, so one fits an SM
BLOCKS_PER_SM = 1


def _lib():
    lib = _build.load("mla_decode")
    fn = lib.mla_decode_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 7 + [_L] * 9 + [ctypes.c_float, _P]
        fn.restype = _I
    return lib


def _check(q, c_kv, k_rope, valid):
    """What the function takes, on every device."""
    B, H, DK = q.shape
    _, T, R = c_kv.shape
    RP = DK - R
    if c_kv.shape[0] != B or k_rope.shape != (B, T, RP) or \
            valid.shape != (B, T):
        raise ValueError("mla_decode: q (B,H,R+RP), c_kv (B,T,R), k_rope "
                         "(B,T,RP), valid (B,T)")
    if q.dtype not in _DTYPES or c_kv.dtype != q.dtype or \
            k_rope.dtype != q.dtype:
        raise TypeError(f"mla_decode: q, c_kv and k_rope must share a dtype "
                        f"of {list(_DTYPES)}, not {q.dtype}, {c_kv.dtype}, "
                        f"{k_rope.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError("mla_decode: valid must be bool")
    for t in (q, c_kv, k_rope, valid):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError("mla_decode: tensors on one device, with a "
                             "unit last-dim stride")


def _check_kernel(q, c_kv, k_rope):
    """What the kernel takes besides: its sizes, the widths it is built
    for, 16-byte bf16 rows."""
    B, H, DK = q.shape
    T, R = c_kv.shape[1], c_kv.shape[2]
    RP = DK - R
    if not 0 < H <= HMAX or not 0 < T <= TMAX or not 0 < B <= BMAX:
        raise ValueError(f"mla_decode: H must be 1..{HMAX}, T 1..{TMAX} "
                         f"and B 1..{BMAX}, not {H}, {T} and {B}")
    if B * -(-T // TILE) > GMAX * MAXT:
        raise ValueError(f"mla_decode: B x ceil(T / {TILE}) must be at most "
                         f"{GMAX * MAXT}, not {B * -(-T // TILE)}")
    if q.dtype == torch.bfloat16 and (R, RP) not in BF16_WIDTHS:
        raise ValueError(f"mla_decode: bf16 widths (R, RP) must be one of "
                         f"{BF16_WIDTHS}, not {(R, RP)}")
    if q.dtype == torch.float32 and (R > F32_RMAX or DK > F32_DKMAX):
        raise ValueError(f"mla_decode: fp32 needs R <= {F32_RMAX} and "
                         f"R + RP <= {F32_DKMAX}")
    if q.dtype == torch.bfloat16:
        for t in (q, c_kv, k_rope):
            if t.data_ptr() % 16 or any(s * 2 % 16 for s in t.stride()[:2]):
                raise ValueError("mla_decode: bf16 rows must be 16-byte "
                                 "aligned")


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def grid_plan(B: int, T: int, num_sms: int) -> int:
    """The first pass's blocks: BLOCKS_PER_SM an SM (at most GMAX), and at
    least enough that none takes more than MAXT of the B rows' tiles."""
    return max(min(GMAX, BLOCKS_PER_SM * num_sms),
               -(-B * -(-T // TILE) // MAXT))


def mla_decode(q: torch.Tensor, c_kv: torch.Tensor, k_rope: torch.Tensor,
               valid: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,H,R+RP); c_kv (B,T,R); k_rope (B,T,RP); valid (B,T) bool ->
    o_lat (B,H,R) in q's dtype (``mla_decode_plain``). A CPU tensor runs
    the plain version, a CUDA tensor launches the kernel; the operands'
    shapes, dtypes and strides are checked on both, the kernel's own limits
    on the card."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, c_kv, k_rope)):
        raise RuntimeError(
            "mla_decode has no gradient: the kernel has no backward (MLA "
            "decode serves; training runs mla_forward); call it under "
            "torch.no_grad()")
    _check(q, c_kv, k_rope, valid)
    if not _build.use_kernel(q):
        return mla_decode_plain(q, c_kv, k_rope, valid, scale)
    _check_kernel(q, c_kv, k_rope)
    B, H, _ = q.shape
    T, R = c_kv.shape[1], c_kv.shape[2]
    G = grid_plan(B, T, _num_sms(q.device.index or 0))
    o = torch.empty((B, H, R), dtype=q.dtype, device=q.device)
    idx = torch.empty(B * (3 + -(-T // TILE)), dtype=torch.int32,
                      device=q.device)
    part = torch.empty((G + B) * H * (R + 2), dtype=torch.float32,
                       device=q.device)
    lib = _lib()
    rc = lib.mla_decode_fwd(
        q.data_ptr(), c_kv.data_ptr(), k_rope.data_ptr(), valid.data_ptr(),
        o.data_ptr(), idx.data_ptr(), part.data_ptr(), _DTYPES[q.dtype], B,
        T, H, R, k_rope.shape[2], G, q.stride(0), q.stride(1), c_kv.stride(0),
        c_kv.stride(1), k_rope.stride(0), k_rope.stride(1), valid.stride(0),
        o.stride(0), o.stride(1), scale, _build.stream_ptr(q))
    _build.check(lib, rc, "mla_decode")
    mla_decode.launches += 1
    return o


mla_decode.launches = 0
