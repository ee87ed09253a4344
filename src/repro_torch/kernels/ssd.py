"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper, its plain version
and its count. The kernel and its design note are in
``repro_torch/csrc/ssd_scan.cu``; it replaces
``src/repro/kernels/ssd.py::ssd_scan_kernel``.

What bounds it on the H100: latency and instruction issue, at the serving
shapes (one chunk of up to 64 tokens at batch 1). The kernel splits each
head's state into P-slices so that batch 1 fills the card, shares B, C and
C.B^T within clusters of blocks of one group, and runs its four products on
the tensor cores in 3xTF32 (fp32 accuracy: the model holds it to 2e-4, so
no one-pass TF32). ``plan`` picks the slice, the stages and the cluster. B and C are read through their
strides, group ``h // (H / G)`` for head ``h``, and x in place from the fused
projection it was split from.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan as ssd_scan_plain

__all__ = ["ssd_scan", "ssd_scan_plain"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
CHUNK_MAX = 128
SMEM_BLOCK = 232_448   # an H100 block's shared memory (opt-in), bytes
SMEM_SM = 233_472      # an SM's, with 1 KB reserved a block
MAX_CLUSTER = 8


def _lib():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 11 + [_L] * 12 + [_P]
        fn.restype = _I
        lib.ssd_scan_smem_bytes.argtypes = [_I] * 4
        lib.ssd_scan_smem_bytes.restype = _L
        lib.ssd_scan_cluster.argtypes = [_I] * 8
        lib.ssd_scan_cluster.restype = _I
    return lib


def smem_bytes(chunk: int, n: int, ps: int, stages: int) -> int:
    """A block's shared memory (the kernel's ``Layout``): seg in fp64, per
    stage C, B (rows of N + 4, N rounded up to 8) and the x slice (PS + 8),
    C.B^T (c + 4), two planes of the split x * w (in C's place where they
    fit), the state slice, three vectors of decays and four mbarriers, with
    the chunk padded to 16 rows."""
    cp = max(chunk, 16)
    n8 = -(-n // 8) * 8
    stage = 2 * cp * (n8 + 4) + cp * (ps + 8)
    # the split x * w goes where C was when it fits and C has no padding,
    # else after C.B^T in a region large enough for either
    in_c = chunk == cp and n == n8 and 2 * (ps + 8) <= n8 + 4
    cb = cp * (cp + 4) if in_c else max(cp * (cp + 4), 2 * cp * (ps + 8))
    return 4 * (2 * cp + stages * stage + cb + ps * (n8 + 4) + 3 * cp + 8)


def plan(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
         sms: int):
    """(ps, stages, cluster) of a launch. ps, the P-slice of a block (a
    power of two from 16): halved from all of P (rounded up to a power of
    two; the kernel pads a slice past P with zeros) while the grid has fewer blocks
    than 15/16 of the SMs, and further while a block's shared memory does
    not fit (a block is instruction-bound: more slices than SMs would add
    blocks that each repeat the staging and the share of C.B^T).
    stages: 2 (the next chunk's copies overlap this one's products) when
    there is more than one chunk and the grid runs in as few waves with two
    as with one, else 1. cluster: the blocks of one group that share C.B^T,
    the largest power of two up to 8 that divides the group's blocks."""
    ps = 16
    while ps < p:
        ps *= 2
    while 16 * b * h * -(-p // ps) < 15 * sms and ps % 32 == 0:
        ps //= 2
    while smem_bytes(chunk, n, ps, 1) > SMEM_BLOCK and ps % 32 == 0:
        ps //= 2
    one = smem_bytes(chunk, n, ps, 1)
    if one > SMEM_BLOCK:
        raise ValueError(f"ssd_scan: chunk {chunk} at N = {n} needs {one} "
                         f"bytes of shared memory a block, over {SMEM_BLOCK}")
    two = smem_bytes(chunk, n, ps, 2)
    grid = b * h * -(-p // ps)

    def waves(nbytes):
        return -(-grid // (sms * (SMEM_SM // (nbytes + 1024))))

    stages = 2 if (s > chunk and two <= SMEM_BLOCK
                   and waves(two) == waves(one)) else 1
    blocks = (h // g) * -(-p // ps)
    cluster = MAX_CLUSTER
    while blocks % cluster:
        cluster //= 2
    return ps, stages, cluster


def _bulk(B: torch.Tensor, C: torch.Tensor) -> bool:
    """Whether every row of B and C is 16-byte aligned and a whole number
    of 16-byte pieces, so that the kernel may copy it by multicast."""
    return B.shape[3] % 4 == 0 and all(
        t.data_ptr() % 16 == 0 and all(st % 4 == 0 for st in t.stride()[:3])
        for t in (B, C))


def cluster_size(b: int, s: int, h: int, p: int, g: int, n: int,
                 chunk: int, device=None) -> int:
    """The cluster a launch at this shape takes on the card: the plan's,
    halved while clusters of it would leave blocks of the grid waiting."""
    idx = torch.cuda.current_device() if device is None else device
    ps, stages, cluster = plan(b, s, h, p, g, n, chunk, _num_sms(idx))
    with torch.cuda.device(idx):
        return _lib().ssd_scan_cluster(b, h, p, n, chunk, ps, stages,
                                       cluster)


def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    _build.refuse_grad("ssd_scan", "ssd_scan_kernel", x, dt, A, B, C)
    if not _build.use_kernel(x):
        return ssd_scan_plain(x, dt, A, B, C)
    _check(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    ps, stages, cluster = plan(b, s, h, p, g, n, chunk,
                               _num_sms(x.get_device()))
    lib = _lib()
    rc = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, h, p, g, n,
        chunk, ps, stages, cluster, int(_bulk(B, C)), *x.stride()[:3],
        *dt.stride(), *B.stride()[:3], *C.stride()[:3],
        _build.stream_ptr(x))
    _build.check(lib, rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
