"""The port's hand-written Hopper kernels against their plain versions, on
the card. Every test is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False. The file imports neither JAX nor
``repro``, so it runs where only the port does:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Inputs come from numpy with a seed. Tolerances: 2e-5 in fp32 and 2e-2 in
bf16 for the attention kernels and RMSNorm (the fused residual sum bit for
bit), 2e-4 for the SSD scan and 1e-5
for the RG-LRU scan (``tests/test_kernels.py``; its fused form's fp32
output too); 5e-4 for a small fp32
model through the kernels against the same model through the plain
versions. A bf16 output must also lie within a relative L2 of 1e-3 of the
plain version's, as ``chip_smoke.py`` holds it (``BF16_REL_L2``).
``TorchBackend``'s CUDA graphs must replay their eager steps bit for bit.
The MoE expert products on the card must be as exact as the widened fp32
product, against fp64. A reduced fp32 model's loss and gradients on the
card must match the CPU's (loss 1e-5 relative, gradients 1e-4 in relative
L2, TF32 off), and every kernel wrapper must refuse autograd there.
"""
import hashlib
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import (device_launches, launch_counts,
                                 profile_calls, traced_launches)
from repro_torch.kernels import mla_decode as mla
from repro_torch.kernels import ops
from repro_torch.kernels import rglru as lru
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import ssd
from repro_torch.models import (build_model, tree_clone, tree_map,
                                tree_tensors)
from repro_torch.serving import BatchPlan, Request, TorchBackend
from repro_torch.serving.graphs import StepGraph

pytestmark = pytest.mark.cuda

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BF16_REL_L2 = 1e-3
DTYPES = ["float32", "bfloat16"]

# the sweeps of tests/test_kernels.py, a group of 3 (llama3-3b's) and the
# serving path's shapes of full-width llama3-3b
FLASH_SHAPES = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 256, 4, 1, 128),
                (2, 384, 6, 2, 64), (1, 40, 6, 2, 128), (1, 1, 24, 8, 128),
                (1, 64, 24, 8, 128)]
# the edges of the bf16 kernel's tiles: 16-row warp tiles and 64-key K/V
# tiles cut by S, groups of 1 to 8 heads, both head dims
FLASH_SHAPES += [(1, S, 2 * G, 2, D) for D in (64, 128) for G in (1, 2, 3, 4, 8)
                 for S in (1, 15, 17, 40, 64, 65, 384)]
DECODE_SHAPES = [(1, 512, 4, 4, 64), (2, 1024, 8, 2, 64), (4, 512, 4, 1, 128),
                 (2, 512, 6, 2, 128), (8, 2048, 24, 8, 128),
                 (8, 2048, 16, 1, 256), (2, 512, 12, 1, 256)]
# the edges of the bf16 kernel's tiles: T = 520 is a multiple of no tile
# (16-slot warp tiles, 64-slot stages), groups of 1 to 16 heads (the rows of
# one 16-row tile), every head dim
DECODE_SHAPES += [(2, 520, 2 * G, 2, D) for D in (64, 128, 256)
                  for G in (1, 2, 3, 4, 6, 8, 12, 16)]
RMS_SHAPES = [(4, 128), (2, 17, 256), (3, 5, 7, 512), (8, 3072),
              (64, 3072)]
# (b, s, h, p, g, n, chunk): the sweep of tests/test_kernels.py, then
# mamba2-1.3b's prefill shapes (chunk = s up to 128, and 128 beyond)
SSD_SHAPES = [(1, 128, 4, 64, 1, 64, 32), (2, 256, 8, 32, 2, 32, 64),
              (1, 64, 2, 64, 1, 128, 16), (1, 1, 64, 64, 1, 128, 1),
              (1, 2, 64, 64, 1, 128, 2), (1, 64, 64, 64, 1, 128, 64),
              (1, 256, 64, 64, 1, 128, 128)]
# beyond them: batch 8 at the serving shape (one slice of all of P), P 32
# over two groups, several chunks with two stages, and a P and an N that no
# tile divides (padded slices and synchronous copies)
SSD_MORE = [(8, 64, 64, 64, 1, 128, 64), (1, 128, 8, 32, 2, 64, 32),
            (2, 192, 16, 64, 1, 128, 64), (1, 40, 4, 24, 2, 20, 8),
            (8, 256, 64, 64, 1, 128, 128), (1, 64, 4, 48, 1, 64, 32)]
# (B, S, W): the sweep of tests/test_kernels.py, then recurrentgemma-9b's;
# beyond them a decode step's one token, S = 3 (chunks of 2, the last cut),
# three time tiles with a cut chunk, and an odd W (a lane tile cut by W)
RGLRU_SHAPES = [(1, 64, 128), (2, 256, 256), (3, 128, 384), (1, 64, 4096),
                (1, 256, 4096), (2, 2, 4096)]
RGLRU_MORE = [(8, 1, 4096), (1, 3, 4096), (2, 300, 4096), (3, 37, 130)]
# the fused form: the sweep, recurrentgemma-9b's 64-token and 2-token
# prefill buckets and its decode step at max_batch 8
RGLRU_GATED_SHAPES = [(1, 64, 128), (2, 256, 256), (3, 128, 384),
                      (1, 64, 4096), (1, 2, 4096), (8, 1, 4096)]
SSD_TOL = dict(rtol=2e-4, atol=2e-4)
LRU_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _dev(a, dtype, device):
    return torch.from_numpy(a).to(getattr(torch, dtype)).to(device)


def _close(got, want, dtype):
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    np.testing.assert_allclose(g, w, **TOL[dtype])
    if dtype == "bfloat16":
        assert np.linalg.norm(g - w) <= BF16_REL_L2 * np.linalg.norm(w)


@pytest.mark.parametrize("B,S,H,Hkv,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain(cuda, B, S, H, Hkv, D, dtype):
    q, k, v = (_dev(a, dtype, cuda) for a in
               _normal(0, (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention.launches == n + 1
    _close(got, fa.flash_attention_plain(q, k, v), dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_noncausal_and_strided(cuda, causal, dtype):
    """Non-causal and causal, q/k/v read through the strides of a fused
    qkv."""
    qkv = _dev(_normal(1, (2, 128, 8, 64))[0], dtype, cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fa.flash_attention(q, k, v, causal=causal)
    _close(got, fa.flash_attention_plain(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("S", [40, 130])
def test_flash_kernel_reads_unaligned_rows(cuda, S):
    """Rows that are not 16-byte aligned (a head_dim stride of 1 inside rows
    of D + 1) take the kernel's synchronous copies, with the same output."""
    B, H, Hkv, D = 1, 6, 2, 64
    q, k, v = (_dev(a, "bfloat16", cuda)[..., :D] for a in
               _normal(3, (B, S, H, D + 1), (B, S, Hkv, D + 1),
                       (B, S, Hkv, D + 1)))
    _close(fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v),
           "bfloat16")


@pytest.mark.parametrize("B,T,H,Hkv,D", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(cuda, B, T, H, Hkv, D, dtype):
    q, kc, vc = _normal(3, (B, 1, H, D), (B, T, Hkv, D), (B, T, Hkv, D))
    lengths = np.random.default_rng(4).integers(1, T + 1, B)
    valid = np.arange(T)[None] < lengths[:, None]
    valid[-1] = False                        # a row with no valid slot
    args = (_dev(q, dtype, cuda), _dev(kc, dtype, cuda),
            _dev(vc, dtype, cuda), torch.from_numpy(valid).to(cuda))
    got = dec.decode_attention(*args)
    assert bool((got[-1] == 0).all())
    _close(got, dec.decode_attention_plain(*args), dtype)


@pytest.mark.parametrize("B,T,H,Hkv,D", [(2, 512, 4, 2, 64),
                                         (8, 2048, 16, 1, 256),
                                         (2, 520, 6, 2, 128),
                                         (2, 520, 32, 2, 256),
                                         (3, 520, 2, 2, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_ring_buffer_validity(cuda, B, T, H, Hkv, D, dtype):
    q, kc, vc = (_dev(a, dtype, cuda) for a in
                 _normal(5, (B, 1, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    valid = torch.from_numpy(
        np.random.default_rng(6).random((B, T)) < 0.7).to(cuda)
    _close(dec.decode_attention(q, kc, vc, valid),
           dec.decode_attention_plain(q, kc, vc, valid), dtype)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_reads_a_strided_cache(cuda, D, dtype):
    """Caches that are a slice of a larger buffer (along slots and heads),
    a q that is a slice of a fused projection, and a validity row with
    holes."""
    B, T, H, Hkv = 2, 520, 12, 2
    big_k, big_v, qkv = _normal(9, (B, T + 9, Hkv + 3, D),
                                (B, T + 9, Hkv + 3, D), (B, 1, H + 4, D))
    kc = _dev(big_k, dtype, cuda)[:, 5:5 + T, 1:1 + Hkv]
    vc = _dev(big_v, dtype, cuda)[:, 2:2 + T, 3:3 + Hkv]
    q = _dev(qkv, dtype, cuda)[:, :, 2:2 + H]
    valid = torch.from_numpy(
        np.random.default_rng(10).random((B, T)) < 0.5).to(cuda)
    _close(dec.decode_attention(q, kc, vc, valid),
           dec.decode_attention_plain(q, kc, vc, valid), dtype)
    # a q whose rows are not 16-byte aligned: the synchronous copy
    q1 = _dev(_normal(13, (B, 1, H, D + 1))[0], dtype, cuda)[..., :D]
    _close(dec.decode_attention(q1, kc, vc, valid),
           dec.decode_attention_plain(q1, kc, vc, valid), dtype)


@pytest.mark.parametrize("chunk", [64, 128, 256, 512, 1024])
@pytest.mark.parametrize("B,T,H,Hkv,D", [(8, 2048, 24, 8, 128),
                                         (8, 2048, 16, 1, 256),
                                         (2, 520, 6, 2, 64)])
def test_decode_kernel_chunks(cuda, monkeypatch, chunk, B, T, H, Hkv, D):
    """Every chunk of slots per block ``tools/tune_attention.py`` times
    gives the plain version's output in bf16, the all-invalid row 0."""
    monkeypatch.setattr(dec, "split_plan_mma",
                        lambda rows, T, sms, D: (chunk, -(-T // chunk)))
    q, kc, vc = _normal(11, (B, 1, H, D), (B, T, Hkv, D), (B, T, Hkv, D))
    lengths = np.random.default_rng(12).integers(1, T + 1, B)
    valid = np.arange(T)[None] < lengths[:, None]
    valid[-1] = False
    args = (_dev(q, "bfloat16", cuda), _dev(kc, "bfloat16", cuda),
            _dev(vc, "bfloat16", cuda), torch.from_numpy(valid).to(cuda))
    got = dec.decode_attention(*args)
    assert bool((got[-1] == 0).all())
    _close(got, dec.decode_attention_plain(*args), "bfloat16")


# (B, T, H, R, RP): deepseek-v2-lite-16b's decode at the benchmark's batch
# and both its caches, a T that no tile divides, and the reduced model's
# widths with a validity row that is not 16-byte aligned (T = 40)
MLA_SHAPES = [(32, 2048, 16, 512, 64), (32, 512, 16, 512, 64),
              (3, 520, 16, 512, 64), (4, 64, 4, 64, 16),
              (2, 40, 4, 64, 16)]


def _mla_case(seed, B, T, H, R, RP, dtype, device, holes=False):
    """q, c_kv, k_rope and valid: ragged contexts (as a decode step's, each
    row's slots up to and including its own new entry), one row whose only
    valid slot is slot 0 and, with more than two rows, one with no valid
    slot; with ``holes`` a random mask instead."""
    q, c_kv, k_rope = (_dev(a, dtype, device) for a in
                       _normal(seed, (B, H, R + RP), (B, T, R), (B, T, RP)))
    rng = np.random.default_rng(seed + 1)
    if holes:
        valid = rng.random((B, T)) < 0.3
    else:
        valid = np.arange(T)[None] < rng.integers(1, T + 1, B)[:, None]
        valid[0] = np.arange(T) < 1
        if B > 2:
            valid[-1] = False
    return q, c_kv, k_rope, torch.from_numpy(valid).to(device)


@pytest.mark.parametrize("B,T,H,R,RP", MLA_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("holes", [False, True])
def test_mla_kernel_matches_plain(cuda, B, T, H, R, RP, dtype, holes):
    """The latent-space MLA decode kernel against its plain version: bf16
    within the relative L2 of 1e-3, fp32 at 2e-5; a row with no valid slot
    gives 0; one launch."""
    args = _mla_case(20, B, T, H, R, RP, dtype, cuda, holes)
    scale = (128 + 64) ** -0.5
    before = mla.mla_decode.launches
    got = mla.mla_decode(*args, scale)
    assert mla.mla_decode.launches == before + 1
    assert got.shape == (B, H, R) and got.dtype == args[0].dtype
    if B > 2 and not holes:
        assert bool((got[-1] == 0).all())
    _close(got, mla.mla_decode_plain(*args, scale), dtype)


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 8, 64])
@pytest.mark.parametrize("T", [520, 2048])
def test_mla_kernel_splits(cuda, monkeypatch, blocks_per_sm, T):
    """Other cuts of the batch's live tiles into the first pass's runs
    (runs that span rows, rows split over many runs, runs of one tile or
    none) give the plain version's output, bf16 and fp32."""
    monkeypatch.setattr(mla, "BLOCKS_PER_SM", blocks_per_sm)
    for dtype in DTYPES:
        args = _mla_case(22, 32, T, 16, 512, 64, dtype, cuda)
        _close(mla.mla_decode(*args, 0.07), mla.mla_decode_plain(*args, 0.07),
               dtype)


def test_mla_kernel_reads_strided_operands(cuda):
    """A q that is a transposed view (as the model passes it), latents and
    rope keys that are slices of larger buffers."""
    B, T, H = 4, 300, 16
    qh, big_c, big_r = _normal(24, (H, B, 576), (B, T + 7, 520),
                               (B, T + 3, 72))
    q = _dev(qh, "bfloat16", cuda).transpose(0, 1)
    c_kv = _dev(big_c, "bfloat16", cuda)[:, 4:4 + T, :512]
    k_rope = _dev(big_r, "bfloat16", cuda)[:, 1:1 + T, 8:]
    valid = torch.from_numpy(
        np.random.default_rng(25).random((B, T)) < 0.6).to(cuda)
    _close(mla.mla_decode(q, c_kv, k_rope, valid, 0.07),
           mla.mla_decode_plain(q, c_kv, k_rope, valid, 0.07), "bfloat16")


# sha256 of the fp32 attention kernels' output bytes, recorded on an H100
# with the block counts of its 132 SMs: flash at llama3-3b's 64-token
# bucket, decode at llama3-3b's cache (a group of 3) and recurrentgemma-9b's
# (a group of 16 at head_dim 256). The fp32 path keeps its order of sums;
# a change to it shows here, where a tolerance would let it pass.
FP32_DIGESTS = {
    "flash (1, 64, 24, 8, 128)":
        "2376b825b742023aeb26e52726258a4761cc045a166c40f8d7d3e9da28cc04fe",
    "decode (8, 2048, 24, 8, 128)":
        "8e98edf107d89e1d5132103347840c5b02fd4ed81416d79b39c508d7721234a7",
    "decode (8, 2048, 16, 1, 256)":
        "ad7675f715931fce53fdab68107dc5eb39b85e260398176a012e2db36c842897",
}


def _fp32_output(case, device):
    """The fp32 kernel's output of one case of ``FP32_DIGESTS``."""
    kind, shape = case.split(" ", 1)
    B, L, H, Hkv, D = (int(x) for x in shape.strip("()").split(", "))
    q, k, v = (torch.from_numpy(a).to(device) for a in _normal(
        14, (B, L if kind == "flash" else 1, H, D), (B, L, Hkv, D),
        (B, L, Hkv, D)))
    if kind == "flash":
        return fa.flash_attention(q, k, v)
    lengths = np.random.default_rng(15).integers(1, L + 1, B)
    valid = np.arange(L)[None] < lengths[:, None]
    valid[-1] = False
    return dec.decode_attention(q, k, v, torch.from_numpy(valid).to(device))


def _digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("case", list(FP32_DIGESTS))
def test_fp32_attention_kernels_keep_their_bits(cuda, monkeypatch, case):
    monkeypatch.setattr(dec, "_num_sms", lambda index: 132)
    assert _digest(_fp32_output(case, cuda)) == FP32_DIGESTS[case]


def _ssd_inputs(seed, b, s, h, p, g, n, device):
    """The distributions of ``test_ssd_sweep``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
    A = np.exp(0.3 * rng.standard_normal((h,)))
    B = 0.5 * rng.standard_normal((b, s, g, n))
    C = 0.5 * rng.standard_normal((b, s, g, n))
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (x, dt, A, B, C)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES + SSD_MORE)
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, g, n, chunk):
    args = _ssd_inputs(6, b, s, h, p, g, n, cuda)
    before = ssd.ssd_scan.launches
    y, st = ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 1
    y_r, st_r = ssd.ssd_scan_plain(*args)
    np.testing.assert_allclose(y.cpu().numpy(), y_r.cpu().numpy(),
                               **SSD_TOL)
    np.testing.assert_allclose(st.cpu().numpy(), st_r.cpu().numpy(),
                               **SSD_TOL)


def test_ssd_kernel_at_mamba2_decay_rates(cuda):
    """mamba2-1.3b's decay rates, A = linspace(1, 16) over the heads, at
    chunk 128: the cumulative log-decay reaches several hundred inside a
    chunk, and the decays must not lose precision to its cancellation."""
    b, s, h, p, g, n = 1, 256, 64, 64, 1, 128
    x, dt, _, B, C = _ssd_inputs(8, b, s, h, p, g, n, cuda)
    A = torch.linspace(1.0, 16.0, h, device=cuda)
    y, st = ssd.ssd_scan(x, dt, A, B, C, chunk=128)
    y_r, st_r = ssd.ssd_scan_plain(x, dt, A, B, C)
    np.testing.assert_allclose(y.cpu().numpy(), y_r.cpu().numpy(),
                               **SSD_TOL)
    np.testing.assert_allclose(st.cpu().numpy(), st_r.cpu().numpy(),
                               **SSD_TOL)


def test_ssd_kernel_reads_strided_inputs(cuda):
    """x, B and C read in place from one fused (b, s, d) buffer, as the
    model splits them, and the chunk picked by ``ops.ssd_scan``."""
    b, s, h, p, g, n = 1, 40, 8, 32, 2, 32
    x, dt, A, B, C = _ssd_inputs(7, b, s, h, p, g, n, cuda)
    fused = torch.cat([x.reshape(b, s, h * p), B.reshape(b, s, g * n),
                       C.reshape(b, s, g * n)], dim=-1)
    xs, Bs, Cs = torch.split(fused, [h * p, g * n, g * n], dim=-1)
    y, st = ops.ssd_scan(xs.reshape(b, s, h, p), dt, A,
                         Bs.reshape(b, s, g, n), Cs.reshape(b, s, g, n))
    y_r, st_r = ssd.ssd_scan_plain(x, dt, A, B, C)
    np.testing.assert_allclose(y.cpu().numpy(), y_r.cpu().numpy(),
                               **SSD_TOL)
    np.testing.assert_allclose(st.cpu().numpy(), st_r.cpu().numpy(),
                               **SSD_TOL)


def test_ssd_kernel_reads_misaligned_inputs(cuda):
    """x, B and C at an odd offset inside one fused buffer, so that no row
    is 16-byte aligned: the kernel's synchronous copies, same output."""
    b, s, h, p, g, n = 1, 64, 8, 32, 2, 32
    x, dt, A, B, C = _ssd_inputs(9, b, s, h, p, g, n, cuda)
    fused = torch.cat([torch.zeros(b, s, 1, device=cuda),
                       x.reshape(b, s, h * p), B.reshape(b, s, g * n),
                       C.reshape(b, s, g * n)], dim=-1)
    _, xs, Bs, Cs = torch.split(fused, [1, h * p, g * n, g * n], dim=-1)
    y, st = ssd.ssd_scan(xs.reshape(b, s, h, p), dt, A,
                         Bs.reshape(b, s, g, n), Cs.reshape(b, s, g, n),
                         chunk=32)
    y_r, st_r = ssd.ssd_scan_plain(x, dt, A, B, C)
    np.testing.assert_allclose(y.cpu().numpy(), y_r.cpu().numpy(),
                               **SSD_TOL)
    np.testing.assert_allclose(st.cpu().numpy(), st_r.cpu().numpy(),
                               **SSD_TOL)


@pytest.mark.parametrize("chunk,n,ps,stages", [(64, 128, 16, 1),
                                               (128, 128, 16, 1),
                                               (64, 128, 64, 2),
                                               (1, 20, 32, 1)])
def test_ssd_plan_shared_memory_is_the_kernels(cuda, chunk, n, ps, stages):
    """The wrapper's count of a block's shared memory is the kernel's."""
    assert ssd._lib().ssd_scan_smem_bytes(chunk, n, ps, stages) == \
        ssd.smem_bytes(chunk, n, ps, stages)


@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(1, 64, 64, 64, 1, 128, 64),
                                               (1, 256, 8, 32, 2, 64, 32)])
def test_ssd_kernel_smaller_clusters(cuda, monkeypatch, cluster, b, s, h, p,
                                     g, n, chunk):
    """Clusters of 1 and 2 blocks (each block builds more of C.B^T, the
    multicast reaches fewer blocks) give the plain version's output."""
    plan = ssd.plan
    monkeypatch.setattr(ssd, "plan", lambda *a: plan(*a)[:2] + (cluster,))
    args = _ssd_inputs(11, b, s, h, p, g, n, cuda)
    y, st = ssd.ssd_scan(*args, chunk=chunk)
    y_r, st_r = ssd.ssd_scan_plain(*args)
    np.testing.assert_allclose(y.cpu().numpy(), y_r.cpu().numpy(),
                               **SSD_TOL)
    np.testing.assert_allclose(st.cpu().numpy(), st_r.cpu().numpy(),
                               **SSD_TOL)


def _rglru_inputs(seed, B, S, W, device):
    """The distributions of ``test_rglru_sweep``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, W))
    log_a = -np.log1p(np.exp(rng.standard_normal((B, S, W))))
    h0 = rng.standard_normal((B, W))
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (x, log_a, h0)]


def _rglru_case(args):
    before = lru.rglru_scan.launches
    ys, hl = lru.rglru_scan(*args)
    torch.cuda.synchronize()
    assert lru.rglru_scan.launches == before + 1
    ys_r, hl_r = lru.rglru_scan_plain(*args)
    np.testing.assert_allclose(ys.cpu().numpy(), ys_r.cpu().numpy(),
                               **LRU_TOL)
    np.testing.assert_allclose(hl.cpu().numpy(), hl_r.cpu().numpy(),
                               **LRU_TOL)
    # the last chunk's fold is the fix-up of its last step
    assert torch.equal(hl, ys[:, -1])


@pytest.mark.parametrize("B,S,W", RGLRU_SHAPES + RGLRU_MORE)
def test_rglru_kernel_matches_plain(cuda, B, S, W):
    _rglru_case(_rglru_inputs(5, B, S, W, cuda))


@pytest.mark.parametrize("tile_w,chunk,chunks", [(8, 4, 32), (32, 4, 8),
                                                 (32, 1, 1), (16, 2, 4),
                                                 (1, 4, 2), (13, 1, 19)])
def test_rglru_kernel_other_plans(cuda, monkeypatch, tile_w, chunk, chunks):
    """Plans the card's SM count does not pick: lane tiles of 1 to 32 (13
    cuts W), every chunk length, one chunk a time tile (a tile per step) and
    32; on contiguous inputs and on strided views, one of them not 16-byte
    aligned."""
    monkeypatch.setattr(lru, "plan",
                        lambda *a: lru.Plan(tile_w, chunk, chunks))
    _rglru_case(_rglru_inputs(6, 3, 70, 256, cuda))
    x, log_a, h0 = _rglru_inputs(7, 2, 40, 260, cuda)
    big = torch.zeros((2, 40, 264), device=cuda)
    big[..., 1:261] = x
    wide = torch.zeros((2, 80, 260), device=cuda)
    wide[:, ::2] = log_a
    _rglru_case([big[..., 1:261], wide[:, ::2], h0])
    gated = _gated_inputs(8, 2, 40, 260, "bfloat16", cuda)
    out, hl = lru.rglru_gated_scan(*gated)
    out_r, hl_r = lru.rglru_gated_scan_plain(*gated)
    _close(out, out_r, "bfloat16")
    np.testing.assert_allclose(hl.cpu().numpy(), hl_r.cpu().numpy(),
                               **LRU_TOL)


def _gated_inputs(seed, B, S, W, dtype, device):
    """xc, the gate pre-activations and the y branch from unit normals, h0
    too, and lambda from the block's init, 0.9 + 0.099 U(0, 1)."""
    xc, pre_i, pre_r, pre_y, h0 = _normal(seed, (B, S, W), (B, S, W),
                                          (B, S, W), (B, S, W), (B, W))
    lam = 0.9 + 0.099 * np.random.default_rng(seed + 1).random(W)
    f32 = [_dev(a, "float32", device) for a in (xc, pre_i, pre_r)]
    return (*f32, _dev(lam.astype(np.float32), "float32", device),
            _dev(pre_y, dtype, device), _dev(h0, "float32", device))


@pytest.mark.parametrize("B,S,W", RGLRU_GATED_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_gated_kernel_matches_plain(cuda, B, S, W, dtype):
    """The fused form against its plain version, the recurrent block's op
    sequence: out in pre_y's dtype (fp32 within the scan's 1e-5, bf16 at
    the bf16 tolerance and rel-L2), h_last within 1e-5; one launch, counted
    as gated or as a step by S."""
    args = _gated_inputs(12, B, S, W, dtype, cuda)
    f = lru.rglru_scan
    n = (f.launches, f.gated_launches, f.step_launches)
    out, hl = lru.rglru_gated_scan(*args)
    torch.cuda.synchronize()
    assert (f.launches, f.gated_launches, f.step_launches) == (
        n[0] + 1, n[1] + (S > 1), n[2] + (S == 1))
    out_r, hl_r = lru.rglru_gated_scan_plain(*args)
    assert out.dtype == out_r.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(out.cpu().numpy(), out_r.cpu().numpy(),
                                   **LRU_TOL)
    else:
        _close(out, out_r, dtype)
    np.testing.assert_allclose(hl.cpu().numpy(), hl_r.cpu().numpy(),
                               **LRU_TOL)


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    x, w = _normal(8, shape, (shape[-1],))
    x, w = _dev(x, dtype, cuda), _dev(1.0 + 0.1 * w, dtype, cuda)
    n, nf = rms.rmsnorm.launches, rms.rmsnorm.fused_launches
    _close(rms.rmsnorm(x, w), rms.rmsnorm_plain(x, w), dtype)
    assert (rms.rmsnorm.launches, rms.rmsnorm.fused_launches) == (n + 1, nf)


def _add_rmsnorm_case(x, r, w, dtype):
    """The fused kernel: s is x + r bit for bit, y the plain norm of it."""
    n, nf = rms.rmsnorm.launches, rms.rmsnorm.fused_launches
    s, y = rms.add_rmsnorm(x, r, w)
    assert (rms.rmsnorm.launches, rms.rmsnorm.fused_launches) == \
        (n + 1, nf + 1)
    assert s.dtype == y.dtype == x.dtype and s.shape == x.shape
    assert torch.equal(s, x + r)
    s_r, y_r = rms.add_rmsnorm_plain(x, r, w)
    assert torch.equal(s, s_r)
    _close(y, y_r, dtype)


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_add_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    x, r, w = _normal(16, shape, shape, (shape[-1],))
    _add_rmsnorm_case(_dev(x, dtype, cuda), _dev(r, dtype, cuda),
                      _dev(1.0 + 0.1 * w, dtype, cuda), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_scalar_and_wide_rows(cuda, dtype):
    """The scalar path (a row view that is not 16-byte aligned, and D = 500,
    a multiple of no bf16 vector), rows wider than a thread keeps in
    registers, and a weight of the other dtype (an fp32 model keeps bf16
    weights)."""
    big, r, w = _normal(17, (6, 3073), (6, 3072), (3072,))
    x = _dev(big, dtype, cuda)[:, 1:]
    assert x.data_ptr() % 16 and x.stride(0) == 3073
    r, w = _dev(r, dtype, cuda), _dev(1.0 + 0.1 * w, dtype, cuda)
    _close(rms.rmsnorm(x, w), rms.rmsnorm_plain(x, w), dtype)
    _add_rmsnorm_case(x, r, w, dtype)
    other = "float32" if dtype == "bfloat16" else "bfloat16"
    _close(rms.rmsnorm(x, w.to(getattr(torch, other))),
           rms.rmsnorm_plain(x, w.to(getattr(torch, other))), dtype)
    for D in (500, 40000):
        x, r, w = _normal(18, (3, D), (3, D), (D,))
        x, r = _dev(x, dtype, cuda), _dev(r, dtype, cuda)
        w = _dev(1.0 + 0.1 * w, dtype, cuda)
        _close(rms.rmsnorm(x, w), rms.rmsnorm_plain(x, w), dtype)
        _add_rmsnorm_case(x, r, w, dtype)


def test_kernel_model_matches_plain(cuda):
    """A reduced group-3 llama3-3b in fp32: forward through the kernels
    against the plain versions, with one launch per layer and norm."""
    cfg = get_config("llama3-3b").reduced().replace(num_heads=6,
                                                    num_kv_heads=2)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32))).to(cuda)
    before = launch_counts()
    lk, _ = build_model(cfg.replace(use_pallas=True)).forward(params, toks)
    lp, _ = build_model(cfg).forward(params, toks)
    after = launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == \
        cfg.num_layers
    assert after["rmsnorm"] - before["rmsnorm"] == 2 * cfg.num_layers + 1
    assert after["rmsnorm_fused"] - before["rmsnorm_fused"] == \
        2 * cfg.num_layers
    np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(),
                               rtol=5e-4, atol=5e-4)


def _hybrid_counts(L):
    """A forward's and a decode step's launches in a hybrid of L layers:
    the fused RG-LRU form once per rec layer in both."""
    rec = 2 * (L // 3) + L % 3
    norms = {"rmsnorm": 2 * L + 1, "rmsnorm_fused": 2 * L}
    return ({**norms, "rglru_scan": rec, "rglru_gated": rec,
             "rglru_gated_step": 0},
            {**norms, "rglru_scan": rec, "rglru_gated": 0,
             "rglru_gated_step": rec, "decode_attention": L // 3})


@pytest.mark.parametrize("arch,counts", [
    ("mamba2-1.3b", lambda L: ({"ssd_scan": L, "rmsnorm": L + 1,
                                "rmsnorm_fused": L},
                               {"ssd_scan": 0, "rmsnorm": L + 1,
                                "rmsnorm_fused": L})),
    ("recurrentgemma-9b", _hybrid_counts),
])
def test_kernel_state_models_match_plain(cuda, arch, counts):
    """Reduced Mamba-2 and RecurrentGemma (5 layers: a unit and a tail) in
    fp32: forward through the kernels against the plain versions, with the
    launches the path should make; then one decode step of each, with its
    launches (RecurrentGemma's recurrence is one fused RG-LRU launch a rec
    layer there too)."""
    cfg = get_config(arch).reduced()
    if cfg.arch_type == "hybrid":
        cfg = cfg.replace(num_layers=5)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40))).to(cuda)
    km = build_model(cfg.replace(use_pallas=True))
    before = launch_counts()
    lk, _ = km.forward(params, toks)
    lp, _ = build_model(cfg).forward(params, toks)
    after = launch_counts()
    fwd_counts, step_counts = counts(cfg.num_layers)
    for name, n in fwd_counts.items():
        assert after[name] - before[name] == n, name
    np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(),
                               rtol=5e-4, atol=5e-4)
    _, cache = km.prefill(params, toks[:, :39])
    pos = torch.full((2,), 39, dtype=torch.long, device=cuda)
    before = launch_counts()
    dl, _ = km.decode_step(params, toks[:, 39:], cache, pos)
    after = launch_counts()
    for name, n in step_counts.items():
        assert after[name] - before[name] == n, name
    np.testing.assert_allclose(dl[:, 0].cpu().numpy(),
                               lk[:, 39].cpu().numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch,kw", [
    ("deepseek-v2-lite-16b", dict(num_layers=3)),
    ("llama4-scout-17b-a16e", dict(num_heads=10, num_kv_heads=2)),
])
def test_kernel_moe_models_match_plain(cuda, arch, kw):
    """Reduced MoE models in fp32: deepseek (MLA) with its dense prefix
    layer and two MoE layers, llama4-scout with 10 query heads over 2 kv
    heads (a group of 5, as the full model's 40 over 8). Forward through
    the kernels against the plain versions, with each kernel's launches;
    then a decode step against the forward."""
    cfg = get_config(arch).reduced().replace(**kw)
    L = cfg.num_layers
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40))).to(cuda)
    km = build_model(cfg.replace(use_pallas=True))
    # MLA's prefill attends by einsum, its decode through mla_decode
    attention = 0 if cfg.use_mla else L
    latent = L if cfg.use_mla else 0
    before = launch_counts()
    lk, _ = km.forward(params, toks)
    after = launch_counts()
    want = {"rmsnorm": 2 * L + 1, "rmsnorm_fused": 2 * L,
            "flash_attention": attention, "decode_attention": 0,
            "mla_decode": 0}
    for name, n in want.items():
        assert after[name] - before[name] == n, name
    lp, _ = build_model(cfg).forward(params, toks)
    np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(),
                               rtol=5e-4, atol=5e-4)
    _, cache = km.prefill(params, toks[:, :39], max_len=48)
    pos = torch.full((2,), 39, dtype=torch.long, device=cuda)
    before = launch_counts()
    dl, _ = km.decode_step(params, toks[:, 39:], cache, pos)
    after = launch_counts()
    assert after["decode_attention"] - before["decode_attention"] == \
        attention
    assert after["mla_decode"] - before["mla_decode"] == latent
    np.testing.assert_allclose(dl[:, 0].cpu().numpy(),
                               lk[:, 39].cpu().numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("N", [8, 64])
def test_moe_expert_products_match_fp32(cuda, N):
    """The MoE expert products on the card (bf16 GEMMs with fp32 outputs,
    an fp32 operand split into three bf16 parts) at deepseek-v2-lite-16b's
    widths, on a decode step's 8 tokens and a 64-token prefill: each as
    exact as the product of the widened operands, against an fp64
    reference (within 2x its largest error, plus fp32's 2e-5 relative
    tolerance of the reference's scale)."""
    from repro_torch.models.blocks import _mm_f32
    E, D, F = 64, 2048, 1408
    x, w, h, wo = _normal(3, (N, D), (E, D, F), (N, E * F), (E * F, D))
    x, w, wo = (_dev(a, "bfloat16", cuda) for a in (x, w, wo))
    w = w * D ** -0.5
    h = torch.from_numpy(h).to(cuda)
    for a, b in ((x[None].expand(E, N, D), w), (h, wo)):
        ref = torch.matmul(a.double(), b.double())
        widened = torch.matmul(a.float(), b.float())
        got = _mm_f32(a, b)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        scale = float(ref.abs().max())
        err = float((got.double() - ref).abs().max())
        assert err <= 2 * float((widened.double() - ref).abs().max()) \
            + 2e-5 * scale, err


# ---------------------------------------------------------------------------
# TorchBackend's CUDA graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-3b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "deepseek-v2-lite-16b",
                                  "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_graph_replays_match_eager(cuda, arch, dtype):
    """The backend's decode graph over four steps of random tokens from a
    random cache, and each prefill bucket's graph, against the eager step
    on a clone of the same cache, bit for bit; the hybrid's rows cross its
    32-slot ring. What the profiler sees one replay of the decode graph
    and of the largest prefill bucket's launch is what their captures
    recorded."""
    cfg = get_config(arch).reduced().replace(dtype=dtype, param_dtype=dtype)
    if cfg.arch_type == "hybrid":
        cfg = cfg.replace(num_layers=5)
    backend = TorchBackend(cfg, max_batch=4, cache_len=64, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for t in tree_tensors(backend.cache):
        t.normal_(generator=gen)
    ref = tree_clone(backend.cache)
    start = [3, 29, 30, 62] if cfg.arch_type == "hybrid" else [3, 20, 40,
                                                                59]
    with torch.no_grad():
        for step in range(4):
            pos = torch.tensor(start, device=cuda) + step
            backend.pos.copy_(pos)
            backend.token.random_(0, cfg.vocab_size, generator=gen)
            got = backend.decode_graph()
            want = backend.model.decode_step(backend.params, backend.token,
                                             ref, pos)[0]
            assert torch.equal(got, want), step
            for a, b in zip(tree_tensors(backend.cache),
                            tree_tensors(ref)):
                assert torch.equal(a, b), step
        for n, graph in backend.prefill_graphs.items():
            toks = torch.zeros((1, n), dtype=torch.long, device=cuda)
            assert torch.equal(graph(),
                               backend.model.forward(backend.params,
                                                     toks)[0]), n
        for graph in (backend.decode_graph,
                      backend.prefill_graphs[max(backend.prefill_graphs)]):
            assert graph.launches, graph.name
            # the profiler loses a trace's kernels now and then (all of
            # them at times): a short trace is taken again, as
            # chip_smoke.py does, 5 times in all
            for _ in range(5):
                events, _, _ = profile_calls(graph, 1)
                seen = traced_launches(events)
                if seen == device_launches(graph.launches):
                    break
                time.sleep(1.0)
            assert seen == device_launches(graph.launches), graph.name


def test_graphed_deepseek_decode_at_full_width_matches_eager(cuda):
    """deepseek-v2-lite-16b at full width (cut to its dense layer and one
    MoE layer), bf16, at the benchmark's batch of 32 over 512 slots: the
    decode graph launches the latent-space MLA kernel once a layer and no
    prefill graph launches it; two replays from a random cache at ragged
    positions (one row at position 0, whose only valid slot is its own new
    entry) equal the eager steps bit for bit, logits and cache."""
    cfg = get_config("deepseek-v2-lite-16b").replace(num_layers=2)
    backend = TorchBackend(cfg, max_batch=32, cache_len=512, device=cuda)
    assert backend.decode_graph.launches["mla_decode"] == cfg.num_layers
    for n, graph in backend.prefill_graphs.items():
        assert graph.launches.get("mla_decode", 0) == 0, n
    gen = torch.Generator(device=cuda).manual_seed(0)
    for t in tree_tensors(backend.cache):
        t.normal_(generator=gen)
    ref = tree_clone(backend.cache)
    start = torch.from_numpy(
        np.random.default_rng(0).integers(0, 510, 32)).to(cuda)
    start[0] = 0
    with torch.no_grad():
        for step in range(2):
            pos = start + step
            backend.pos.copy_(pos)
            backend.token.random_(0, cfg.vocab_size, generator=gen)
            got = backend.decode_graph()
            want = backend.model.decode_step(backend.params, backend.token,
                                             ref, pos)[0]
            assert torch.equal(got, want), step
            for a, b in zip(tree_tensors(backend.cache),
                            tree_tensors(ref)):
                assert torch.equal(a, b), step


def test_a_failed_capture_raises(cuda, monkeypatch):
    """A kernel wrapper that raises under capture makes the backend raise:
    no backend comes back, none that runs eagerly."""
    real = rms._launch

    def refuses_capture(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused under capture")
        return real(*args, **kw)

    monkeypatch.setattr(rms, "_launch", refuses_capture)
    with pytest.raises(RuntimeError, match="CUDA graph failed"):
        TorchBackend(get_config("tinyllama-1.1b").reduced(), max_batch=2,
                     cache_len=32, device=cuda)


def test_a_graph_times_its_own_replay(cuda):
    """``StepGraph.device_ms`` is the card's time of the replay alone:
    launched behind a long kernel, the replay waits on the card, and its
    graph's own events leave that wait out."""
    graph = StepGraph(lambda: torch.cuda._sleep(1_000_000), cuda)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        start.record()
        torch.cuda._sleep(10_000_000)
        graph()
        end.record()
        torch.cuda.synchronize(cuda)
        whole, own = start.elapsed_time(end), graph.device_ms()
        assert 0.0 < own < 0.25 * whole, (own, whole)


def test_replays_are_timed_on_the_card(cuda):
    """With the span trace forced on, each graph replay's span carries the
    card's time between its two CUDA events: more than nothing, and no more
    than the host's whole ``execute`` around it, which waits for the card.
    A mixed iteration's two replays are timed apart."""
    cfg = get_config("tinyllama-1.1b").reduced()
    backend = TorchBackend(cfg, max_batch=2, cache_len=64, device=cuda)
    backend.trace.force = True

    def req(ctx):
        r = Request(arrival_time=0.0, prompt_len=ctx, output_len=8)
        r.prefilled = ctx
        return r
    plans = [BatchPlan(prefill=[(req(0), 40)], decode=[]),
             BatchPlan(prefill=[], decode=[req(40)]),
             BatchPlan(prefill=[(req(0), 16)], decode=[req(41), req(7)])]
    for plan in plans:
        assert backend.trace.begin()
        backend.execute(plan, backend.dvfs.spec.f_max)
    by = backend.trace.by_iteration()
    assert sorted(by) == [0, 1, 2]
    for i, want in enumerate([["backend.replay.prefill"],
                              ["backend.replay.decode"],
                              ["backend.replay.prefill",
                               "backend.replay.decode"]]):
        (ex,) = [s for s in by[i] if s.name == "backend.execute"]
        reps = sorted((s for s in by[i] if s.name.startswith(
            "backend.replay.")), key=lambda s: s.start_ns)
        assert [s.name for s in reps] == want
        host_ms = (ex.end_ns - ex.start_ns) / 1e6
        for s in reps:
            assert 0.0 < s.device_ms <= host_ms, (i, s)


# -- training on the card ------------------------------------------------

def _rel_l2(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b",
                                  "recurrentgemma-9b",
                                  "deepseek-v2-lite-16b", "whisper-medium"])
def test_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch, arch):
    """A reduced fp32 model's loss and gradients on the card against the
    CPU on the same weights and batch (loss 1e-5 relative, every gradient
    leaf 1e-4 in relative L2), TF32 off; then one train step on each: the
    same loss, and params 1e-4 apart."""
    from repro_torch.data import synthetic_token_batches
    from repro_torch.training import init_adamw, make_train_step
    from repro_torch.training.train_loop import to_device
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda), cpu)
    batch = next(synthetic_token_batches(
        cfg.vocab_size, 2, 16, seed=0, with_frames=cfg.is_encoder_decoder,
        frame_len=cfg.encoder_seq, d_model=cfg.d_model))
    losses, grads = [], []
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        b = to_device(batch, dev)
        for t in tree_tensors(params):
            t.requires_grad_(True)
        args = [b["tokens"], b["labels"]] + (
            [b["frames"]] if "frames" in b else [])
        loss = model.loss(params, *args)
        loss.backward()
        losses.append(loss.item())
        grads.append([t.grad for t in tree_tensors(params)])
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    assert max(_rel_l2(g, c) for g, c in zip(*grads)) <= 1e-4
    metrics = []
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        step = make_train_step(model)
        _, _, m = step(params, init_adamw(params), to_device(batch, dev))
        metrics.append(m)
    assert abs(float(metrics[1]["loss"]) - float(metrics[0]["loss"])) <= \
        1e-5 * abs(float(metrics[0]["loss"]))
    assert max(_rel_l2(g, c) for g, c in zip(tree_tensors(card),
                                            tree_tensors(cpu))) <= 1e-4


def _refusal_cases(device):
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g).to(device)

    x, w = r(2, 8, 64), r(64)
    q, k, v = r(1, 8, 4, 64), r(1, 8, 2, 64), r(1, 8, 2, 64)
    valid = torch.ones((1, 8), dtype=torch.bool, device=device)
    sx, sdt = r(1, 8, 2, 16), r(1, 8, 2).abs()
    sA, sB, sC = -r(2).abs(), r(1, 8, 1, 16), r(1, 8, 1, 16)
    lx, la, h0 = r(1, 8, 32), -r(1, 8, 32).abs(), r(1, 32)
    lam = r(32).abs()
    return {
        "rmsnorm": (ops.rmsnorm, (x, w)),
        "add_rmsnorm": (ops.add_rmsnorm, (x, x + 1, w)),
        "flash_attention": (ops.flash_attention, (q, k, v)),
        "decode_attention": (ops.decode_attention, (q[:, :1], k, v, valid)),
        "ssd_scan": (ops.ssd_scan, (sx, sdt, sA, sB, sC)),
        "rglru_scan": (ops.rglru_scan, (lx, la, h0)),
        "rglru_gated_scan": (ops.rglru_gated_scan,
                             (lx, lx, lx, lam, lx, h0)),
        "mla_decode": (lambda *a: ops.mla_decode(*a, 0.1),
                       (r(1, 4, 80), r(1, 8, 64), r(1, 8, 16), valid)),
    }


@pytest.mark.parametrize("name", ["rmsnorm", "add_rmsnorm",
                                  "flash_attention", "decode_attention",
                                  "ssd_scan", "rglru_scan",
                                  "rglru_gated_scan", "mla_decode"])
def test_kernel_wrappers_refuse_autograd_on_the_card(cuda, name):
    """Each wrapper, given CUDA tensors of which one requires grad, raises
    and launches nothing; under ``torch.no_grad()`` it launches."""
    wrapper, args = _refusal_cases(cuda)[name]
    for i in [i for i, a in enumerate(args) if a.is_floating_point()]:
        call = [a.clone().requires_grad_(j == i) if a.is_floating_point()
                else a for j, a in enumerate(args)]
        before = launch_counts()
        with pytest.raises(RuntimeError, match=f"^{name} has no gradient"):
            wrapper(*call)
        assert launch_counts() == before
        with torch.no_grad():
            wrapper(*call)
        torch.cuda.synchronize()
        assert launch_counts() != before
