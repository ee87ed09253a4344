"""The port's hand-written Hopper kernels against their plain versions, on
the card. Every test is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False. The file imports neither JAX nor
``repro``, so it runs where only the port does:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Inputs come from numpy with a seed. Tolerances: 2e-5 in fp32 and 2e-2 in
bf16 for the attention kernels and RMSNorm, 2e-4 for the SSD scan and 1e-5
for the RG-LRU scan (``tests/test_kernels.py``); 5e-4 for a small fp32
model through the kernels against the same model through the plain
versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ops
from repro_torch.kernels import rglru as lru
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import ssd
from repro_torch.models import build_model

pytestmark = pytest.mark.cuda

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ["float32", "bfloat16"]

# the sweeps of tests/test_kernels.py, a group of 3 (llama3-3b's) and the
# serving path's shapes of full-width llama3-3b
FLASH_SHAPES = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 256, 4, 1, 128),
                (2, 384, 6, 2, 64), (1, 40, 6, 2, 128), (1, 1, 24, 8, 128),
                (1, 64, 24, 8, 128)]
DECODE_SHAPES = [(1, 512, 4, 4, 64), (2, 1024, 8, 2, 64), (4, 512, 4, 1, 128),
                 (2, 512, 6, 2, 128), (8, 2048, 24, 8, 128),
                 (8, 2048, 16, 1, 256), (2, 512, 12, 1, 256)]
RMS_SHAPES = [(4, 128), (2, 17, 256), (3, 5, 7, 512), (8, 3072),
              (64, 3072)]
# (b, s, h, p, g, n, chunk): the sweep of tests/test_kernels.py, then
# mamba2-1.3b's prefill shapes (chunk = s up to 128, and 128 beyond)
SSD_SHAPES = [(1, 128, 4, 64, 1, 64, 32), (2, 256, 8, 32, 2, 32, 64),
              (1, 64, 2, 64, 1, 128, 16), (1, 1, 64, 64, 1, 128, 1),
              (1, 2, 64, 64, 1, 128, 2), (1, 64, 64, 64, 1, 128, 64),
              (1, 256, 64, 64, 1, 128, 128)]
# (B, S, W): the sweep of tests/test_kernels.py, then recurrentgemma-9b's
RGLRU_SHAPES = [(1, 64, 128), (2, 256, 256), (3, 128, 384), (1, 64, 4096),
                (1, 256, 4096), (2, 2, 4096)]
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
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("B,S,H,Hkv,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain(cuda, B, S, H, Hkv, D, dtype):
    q, k, v = (_dev(a, dtype, cuda) for a in
               _normal(0, (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention.launches == n + 1
    _close(got, fa.flash_attention_plain(q, k, v), dtype)


def test_flash_kernel_noncausal_and_strided(cuda):
    """Non-causal, and q/k/v read through the strides of a fused qkv."""
    qkv = _dev(_normal(1, (2, 128, 8, 64))[0], "float32", cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fa.flash_attention(q, k, v, causal=False)
    _close(got, fa.flash_attention_plain(q, k, v, causal=False), "float32")


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
                                         (8, 2048, 16, 1, 256)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_ring_buffer_validity(cuda, B, T, H, Hkv, D, dtype):
    q, kc, vc = (_dev(a, dtype, cuda) for a in
                 _normal(5, (B, 1, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    valid = torch.from_numpy(
        np.random.default_rng(6).random((B, T)) < 0.7).to(cuda)
    _close(dec.decode_attention(q, kc, vc, valid),
           dec.decode_attention_plain(q, kc, vc, valid), dtype)


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


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
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


@pytest.mark.parametrize("B,S,W", RGLRU_SHAPES)
def test_rglru_kernel_matches_plain(cuda, B, S, W):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, W))
    log_a = -np.log1p(np.exp(rng.standard_normal((B, S, W))))
    h0 = rng.standard_normal((B, W))
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda)
            for a in (x, log_a, h0)]
    before = lru.rglru_scan.launches
    ys, hl = lru.rglru_scan(*args)
    torch.cuda.synchronize()
    assert lru.rglru_scan.launches == before + 1
    ys_r, hl_r = lru.rglru_scan_plain(*args)
    np.testing.assert_allclose(ys.cpu().numpy(), ys_r.cpu().numpy(),
                               **LRU_TOL)
    np.testing.assert_allclose(hl.cpu().numpy(), hl_r.cpu().numpy(),
                               **LRU_TOL)


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    x, w = _normal(8, shape, (shape[-1],))
    x, w = _dev(x, dtype, cuda), _dev(1.0 + 0.1 * w, dtype, cuda)
    _close(rms.rmsnorm(x, w), rms.rmsnorm_plain(x, w), dtype)


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
    np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(),
                               rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("arch,counts", [
    ("mamba2-1.3b", lambda L: {"ssd_scan": L, "rmsnorm": L + 1}),
    ("recurrentgemma-9b", lambda L: {"rglru_scan": 2 * (L // 3) + L % 3,
                                     "rmsnorm": 2 * L + 1}),
])
def test_kernel_state_models_match_plain(cuda, arch, counts):
    """Reduced Mamba-2 and RecurrentGemma (5 layers: a unit and a tail) in
    fp32: forward through the kernels against the plain versions, with the
    launches the path should make; then one decode step of each."""
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
    for name, n in counts(cfg.num_layers).items():
        assert after[name] - before[name] == n, name
    np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(),
                               rtol=5e-4, atol=5e-4)
    _, cache = km.prefill(params, toks[:, :39])
    pos = torch.full((2,), 39, dtype=torch.long, device=cuda)
    dl, _ = km.decode_step(params, toks[:, 39:], cache, pos)
    np.testing.assert_allclose(dl[:, 0].cpu().numpy(),
                               lk[:, 39].cpu().numpy(), rtol=1e-3, atol=1e-3)
