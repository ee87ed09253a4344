"""The port's kernels against the JAX package's, on the shape and dtype
sweeps of ``tests/test_kernels.py``.

On the CPU each wrapper runs its plain PyTorch version; those are held
against both ``repro.kernels.ref`` (the jnp oracles) and ``repro.kernels.ops``
(the Pallas kernels in interpret mode), on the same numpy inputs. Tolerances
are the reference tests': 2e-5 in fp32, 2e-2 in bf16 (bf16 inputs are
rounded once from the same fp32 values in both frameworks). The
hand-written kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.kernels import rmsnorm as rms

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ["float32", "bfloat16"]

FLASH_SHAPES = [
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 8, 2, 64),     # GQA group=4
    (1, 256, 4, 1, 128),    # MQA, wide head
    (2, 384, 6, 2, 64),     # group=3, as llama3-3b has
    (1, 40, 6, 2, 128),     # a prefill shorter than one tile
]
DECODE_SHAPES = [
    (1, 512, 4, 4, 64),
    (2, 1024, 8, 2, 64),
    (4, 512, 4, 1, 128),
    (2, 512, 6, 2, 128),    # group=3
]
RMS_SHAPES = [(4, 128), (2, 17, 256), (3, 5, 7, 512), (8, 3072)]


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL[dtype])


def _np(t):
    return t.float().cpu().numpy()


def _decode_inputs(seed, B, T, H, Hkv, D):
    q, kc, vc = _normal(seed, (B, 1, H, D), (B, T, Hkv, D), (B, T, Hkv, D))
    lengths = np.random.default_rng(seed + 1).integers(1, T + 1, B)
    valid = np.arange(T)[None] < lengths[:, None]
    return q, kc, vc, valid


# ---------------------------------------------------------------------------
# plain versions against the JAX package (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,Hkv,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_matches_jax(B, S, H, Hkv, D, dtype):
    q, k, v = _normal(0, (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    got = _np(ops.flash_attention(*(_torch(a, dtype) for a in (q, k, v)),
                                  causal=True))
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    _close(got, jref.flash_attention(jq, jk, jv, causal=True), dtype)
    _close(got, jops.flash_attention(jq, jk, jv, causal=True), dtype)


def test_flash_attention_noncausal_matches_jax():
    q, k, v = _normal(1, (2, 128, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64))
    got = _np(ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=False))
    _close(got, jref.flash_attention(q, k, v, causal=False), "float32")
    _close(got, jops.flash_attention(q, k, v, causal=False), "float32")


@pytest.mark.parametrize("B,T,H,Hkv,D", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_matches_jax(B, T, H, Hkv, D, dtype):
    q, kc, vc, valid = _decode_inputs(3, B, T, H, Hkv, D)
    got = _np(ops.decode_attention(_torch(q, dtype), _torch(kc, dtype),
                                   _torch(vc, dtype),
                                   torch.from_numpy(valid)))
    jargs = (_jax(q, dtype), _jax(kc, dtype), _jax(vc, dtype),
             jnp.asarray(valid))
    _close(got, jref.decode_attention(*jargs), dtype)
    _close(got, jops.decode_attention(*jargs), dtype)


def test_decode_attention_ring_buffer_validity_matches_jax():
    """Scattered validity (ring-buffer decode) — not just a prefix mask."""
    B, T, H, Hkv, D = 2, 512, 4, 2, 64
    q, kc, vc = _normal(4, (B, 1, H, D), (B, T, Hkv, D), (B, T, Hkv, D))
    valid = np.random.default_rng(5).random((B, T)) < 0.7
    got = _np(ops.decode_attention(*(torch.from_numpy(a)
                                     for a in (q, kc, vc, valid))))
    _close(got, jref.decode_attention(q, kc, vc, valid), "float32")
    _close(got, jops.decode_attention(q, kc, vc, valid), "float32")


def test_decode_attention_all_invalid_row_is_zero_as_pallas():
    """A row with no valid slot gives 0, as the Pallas kernel does; the jnp
    oracle gives mean(V) there instead (a uniform softmax over -1e30)."""
    B, T, H, Hkv, D = 2, 512, 6, 2, 64
    q, kc, vc, valid = _decode_inputs(6, B, T, H, Hkv, D)
    valid[1] = False
    got = _np(ops.decode_attention(*(torch.from_numpy(a)
                                     for a in (q, kc, vc, valid))))
    pallas = np.asarray(jops.decode_attention(q, kc, vc, valid))
    np.testing.assert_array_equal(pallas[1], 0.0)
    np.testing.assert_array_equal(got[1], 0.0)
    _close(got, pallas, "float32")
    oracle = np.asarray(jref.decode_attention(q, kc, vc, valid))
    _close(got[0], oracle[0], "float32")
    assert np.abs(oracle[1]).max() > 0.0


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matches_jax(shape, dtype):
    x, w = _normal(8, shape, (shape[-1],))
    w = 1.0 + 0.1 * w
    got = _np(ops.rmsnorm(_torch(x, dtype), _torch(w, dtype)))
    _close(got, jref.rmsnorm(_jax(x, dtype), _jax(w, dtype)), dtype)
    _close(got, jops.rmsnorm(_jax(x, dtype), _jax(w, dtype)), dtype)


def test_cpu_tensors_run_the_plain_versions_uncounted():
    reset_launch_counts()
    x = torch.randn(3, 64)
    torch.testing.assert_close(ops.rmsnorm(x, torch.ones(64)),
                               rms.rmsnorm_plain(x, torch.ones(64)),
                               rtol=0, atol=0)
    q = torch.randn(1, 8, 2, 64)
    ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    ops.decode_attention(q[:, :1], q, q, torch.ones(1, 8, dtype=torch.bool))
    ops.ssd_scan(q, q[..., 0], torch.ones(2), q[:, :, :1], q[:, :, :1],
                 chunk=8)
    x = torch.randn(2, 8, 64)
    ops.rglru_scan(x, -torch.rand(2, 8, 64), x[:, 0])
    assert launch_counts() == {"rmsnorm": 0, "flash_attention": 0,
                               "decode_attention": 0, "ssd_scan": 0,
                               "rglru_scan": 0}


def test_other_devices_raise():
    x = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.rmsnorm(x, torch.empty(64, device="meta"))
    q = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :1], q, q,
                             torch.empty(1, 4, dtype=torch.bool,
                                         device="meta"))
    with pytest.raises(ValueError):
        ops.ssd_scan(q, q[..., 0], torch.empty(2, device="meta"),
                     q[:, :, :1], q[:, :, :1], chunk=4)
    with pytest.raises(ValueError):
        ops.rglru_scan(q[0], q[0], q[0, 0])


def test_kernel_builds_go_into_the_checkout(monkeypatch, tmp_path):
    from pathlib import Path

    from repro_torch.kernels import _build
    root = Path(__file__).resolve().parents[1]
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert _build.build_dir() == root / "build" / "kernels"
    assert _build._lib_path("decode_attention").parent == (
        root / "build" / "kernels")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert _build._lib_path("flash_attention").parent == tmp_path


def test_ops_take_no_tile_arguments():
    q = torch.randn(1, 8, 2, 64)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q, q, block_q=64)
    with pytest.raises(TypeError):
        ops.decode_attention(q[:, :1], q, q,
                             torch.ones(1, 8, dtype=torch.bool), block_k=64)
