"""RG-LRU linear recurrence, alone (``rglru_scan``) or with the recurrent
block's gates around it (``rglru_gated_scan``): the CUDA kernel's wrappers,
their plain versions, the launch plan and the counts. The kernel and its
design note are in ``repro_torch/csrc/rglru_scan.cu``; it replaces
``src/repro/kernels/rglru.py::rglru_scan_kernel``.

What bounds it on the H100: at the serving shapes, the latency of one round
of loads and then instruction throughput (the fused form's gates cost some 100
instructions an element). A block owns a tile of lanes of W and splits time
into chunks, one a thread, scanned from zero and carried across in shared
memory, so that batch 1 fills the card with many warps an SM (``plan``).
The kernel picks its own tiles, so the ``block_w`` and ``block_s`` of the
Pallas kernel are not taken.

``rglru_scan.launches`` counts every launch of the kernel, alone or fused;
of the fused ones, ``rglru_scan.gated_launches`` counts those over two or
more steps and ``rglru_scan.step_launches`` those over one (a decode step).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_gated_scan as rglru_gated_scan_plain
from repro_torch.kernels.ref import rglru_scan as rglru_scan_plain

__all__ = ["rglru_scan", "rglru_gated_scan", "rglru_scan_plain",
           "rglru_gated_scan_plain", "plan", "chunk_bounds", "Plan"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # ReproDType in common.cuh
PALLAS = "rglru_scan_kernel"

MAX_THREADS = 256  # threads of a block (as in the source)
MAX_TILE_W = 32    # lanes of a block's tile: a warp across W


class Plan(NamedTuple):
    """A launch: a block owns ``tile_w`` lanes of W and walks time in tiles
    of ``chunks`` chunks of ``chunk`` steps; a thread takes one lane of one
    chunk."""
    tile_w: int
    chunk: int
    chunks: int

    @property
    def threads(self) -> int:
        return self.tile_w * self.chunks

    def blocks(self, B: int, W: int) -> int:
        return B * -(-W // self.tile_w)


@functools.lru_cache(maxsize=None)
def plan(B: int, S: int, W: int, sms: int = 132) -> Plan:
    """The launch at (B, S, W) on a card of ``sms`` SMs. Chunks of 4 steps
    (1 at S = 1, 2 at S = 2 and 3): few elements a thread, so that an SM holds
    many warps to hide the latency of the gates' arithmetic. The tile of
    lanes starts at a warp's width (128 bytes a row) and is halved, down to
    8 lanes, while the grid has fewer blocks than two an SM (15/16 of them);
    the time tile is as many chunks as S needs, at most as many as keep a
    block within ``MAX_THREADS`` (a longer S walks several tiles)."""
    chunk = 1 if S == 1 else 2 if S < 4 else 4
    tw = MAX_TILE_W
    while B * -(-W // tw) < 2 * 15 * sms / 16 and tw > 8:
        tw //= 2
    return Plan(tw, chunk, min(-(-S // chunk), MAX_THREADS // tw))


def chunk_bounds(S: int, p: Plan) -> List[Tuple[int, int]]:
    """The (start, stop) of every chunk the kernel scans over S steps, in
    order: time tiles of ``p.chunks`` chunks of ``p.chunk`` steps, the last
    chunk cut at S (the kernel treats a step past S as the identity)."""
    T = p.chunk * p.chunks
    return [(s, min(s + p.chunk, S)) for t0 in range(0, S, T)
            for s in range(t0, min(t0 + T, S), p.chunk)]


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 3 + [_L] * 5 + [_I] * 3 + [_P]
        fn.restype = _I
        fn = lib.rglru_gated_scan_fwd
        fn.argtypes = [_P] * 8 + [_I] * 3 + [_L] * 9 + [_I] * 4 + [_P]
        fn.restype = _I
    return lib


def _plan(x: torch.Tensor) -> Plan:
    B, S, W = x.shape
    return plan(B, S, W, _num_sms(x.get_device()))


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
    _build.refuse_grad("rglru_scan", PALLAS, x, log_a, h0)
    if not _build.use_kernel(x):
        return rglru_scan_plain(x, log_a, h0)
    _check(x, log_a, h0)
    B, S, W = x.shape
    ys = torch.empty((B, S, W), dtype=torch.float32, device=x.device)
    h_last = torch.empty((B, W), dtype=torch.float32, device=x.device)
    p = _plan(x)
    lib = _lib()
    rc = lib.rglru_scan_fwd(
        x.data_ptr(), log_a.data_ptr(), h0.data_ptr(), ys.data_ptr(),
        h_last.data_ptr(), B, S, W, x.stride(0), x.stride(1),
        log_a.stride(0), log_a.stride(1), h0.stride(0), p.tile_w, p.chunk,
        p.chunks, _build.stream_ptr(x))
    _build.check(lib, rc, "rglru_scan")
    rglru_scan.launches += 1
    return ys, h_last


def _check_gated(xc, pre_i, pre_r, lam, pre_y, h0):
    B, S, W = xc.shape
    if (pre_i.shape != (B, S, W) or pre_r.shape != (B, S, W)
            or pre_y.shape != (B, S, W) or lam.shape != (W,)
            or h0.shape != (B, W)):
        raise ValueError("rglru_gated_scan: xc, pre_i, pre_r, pre_y "
                         "(B,S,W), lam (W,), h0 (B,W)")
    for t in (xc, pre_i, pre_r, lam, h0):
        if t.dtype != torch.float32:
            raise TypeError("rglru_gated_scan: xc, pre_i, pre_r, lam and h0 "
                            f"in fp32 only, got {t.dtype}")
    if pre_y.dtype not in _DTYPES:
        raise TypeError(f"rglru_gated_scan: pre_y in fp32 or bf16, got "
                        f"{pre_y.dtype}")
    for t in (pre_i, pre_r, lam, pre_y, h0):
        if t.device != xc.device:
            raise ValueError("rglru_gated_scan: tensors on one device")
    for t in (xc, pre_i, pre_r, lam, pre_y, h0):
        if t.stride(-1) != 1:
            raise ValueError("rglru_gated_scan: a unit W stride")


def rglru_gated_scan(xc: torch.Tensor, pre_i: torch.Tensor,
                     pre_r: torch.Tensor, lam: torch.Tensor,
                     pre_y: torch.Tensor, h0: torch.Tensor):
    """The recurrent block from its three products on, in one launch:
    xc, pre_i, pre_r (B,S,W) fp32; lam (W,) fp32; pre_y (B,S,W) fp32 or
    bf16; h0 (B,W) fp32 -> (out (B,S,W) in pre_y's dtype, h_last (B,W)
    fp32), as ``ref.rglru_gated_scan`` computes them. On a CUDA tensor
    launches the kernel, on a CPU tensor runs the plain version."""
    _build.refuse_grad("rglru_gated_scan", PALLAS, xc, pre_i, pre_r, lam,
                       pre_y, h0)
    if not _build.use_kernel(xc):
        return rglru_gated_scan_plain(xc, pre_i, pre_r, lam, pre_y, h0)
    _check_gated(xc, pre_i, pre_r, lam, pre_y, h0)
    B, S, W = xc.shape
    out = torch.empty((B, S, W), dtype=pre_y.dtype, device=xc.device)
    h_last = torch.empty((B, W), dtype=torch.float32, device=xc.device)
    p = _plan(xc)
    lib = _lib()
    rc = lib.rglru_gated_scan_fwd(
        xc.data_ptr(), pre_i.data_ptr(), pre_r.data_ptr(), lam.data_ptr(),
        pre_y.data_ptr(), h0.data_ptr(), out.data_ptr(), h_last.data_ptr(),
        B, S, W, xc.stride(0), xc.stride(1), pre_i.stride(0),
        pre_i.stride(1), pre_r.stride(0), pre_r.stride(1), pre_y.stride(0),
        pre_y.stride(1), h0.stride(0), p.tile_w, p.chunk, p.chunks,
        _DTYPES[pre_y.dtype], _build.stream_ptr(xc))
    _build.check(lib, rc, "rglru_gated_scan")
    rglru_scan.launches += 1
    if S == 1:
        rglru_scan.step_launches += 1
    else:
        rglru_scan.gated_launches += 1
    return out, h_last


rglru_scan.launches = 0
rglru_scan.gated_launches = 0
rglru_scan.step_launches = 0
