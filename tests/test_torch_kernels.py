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
from repro.kernels.ssd import ssd_scan_kernel
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.kernels import rglru as lru
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import ssd
from repro_torch.kernels.mla_decode import mla_decode_plain
from repro_torch.kernels.ssd_step import ssd_step_plain

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


@pytest.mark.parametrize("shape", RMS_SHAPES + [(64, 3072)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_add_rmsnorm_matches_jax(shape, dtype):
    """The residual add taken into the norm: s equals JAX's ``x + r`` bit
    for bit (both round the fp32 sum once to the dtype), and y is the Pallas
    kernel's norm of it (interpret mode) within the kernel tolerance."""
    x, r, w = _normal(9, shape, shape, (shape[-1],))
    w = 1.0 + 0.1 * w
    s, y = ops.add_rmsnorm(_torch(x, dtype), _torch(r, dtype),
                           _torch(w, dtype))
    js = _jax(x, dtype) + _jax(r, dtype)
    np.testing.assert_array_equal(_np(s), np.asarray(js, np.float32))
    assert s.dtype == y.dtype == getattr(torch, dtype)
    _close(_np(y), jops.rmsnorm(js, _jax(w, dtype)), dtype)
    _close(_np(y), jref.rmsnorm(js, _jax(w, dtype)), dtype)


def test_cpu_tensors_run_the_plain_versions_uncounted():
    reset_launch_counts()
    x = torch.randn(3, 64)
    torch.testing.assert_close(ops.rmsnorm(x, torch.ones(64)),
                               rms.rmsnorm_plain(x, torch.ones(64)),
                               rtol=0, atol=0)
    s, y = ops.add_rmsnorm(x, x, torch.ones(64))
    torch.testing.assert_close(s, x + x, rtol=0, atol=0)
    torch.testing.assert_close(y, rms.rmsnorm_plain(x + x, torch.ones(64)),
                               rtol=0, atol=0)
    q = torch.randn(1, 8, 2, 64)
    ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    ops.decode_attention(q[:, :1], q, q, torch.ones(1, 8, dtype=torch.bool))
    ops.ssd_scan(q, q[..., 0], torch.ones(2), q[:, :, :1], q[:, :, :1],
                 chunk=8)
    x = torch.randn(2, 8, 64)
    ops.rglru_scan(x, -torch.rand(2, 8, 64), x[:, 0])
    lam = torch.rand(64)
    for s in (8, 1):          # a prefill and a decode step
        args = (x[:, :s], x[:, :s], x[:, :s], lam, x[:, :s], x[:, 0])
        for got, want in zip(ops.rglru_gated_scan(*args),
                             lru.rglru_gated_scan_plain(*args)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    lat = torch.randn(2, 8, 80)
    torch.testing.assert_close(
        ops.mla_decode(lat[:, :4], lat[..., :64], lat[..., 64:],
                       torch.ones(2, 8, dtype=torch.bool), 0.1),
        mla_decode_plain(lat[:, :4], lat[..., :64], lat[..., 64:],
                         torch.ones(2, 8, dtype=torch.bool), 0.1),
        rtol=0, atol=0)
    torch.testing.assert_close(
        ops.mla_decode_wide(lat[:, :4], lat[..., :64], lat[..., 64:],
                            torch.ones(2, 8, dtype=torch.bool), 0.1),
        mla_decode_plain(lat[:, :4], lat[..., :64], lat[..., 64:],
                         torch.ones(2, 8, dtype=torch.bool), 0.1),
        rtol=0, atol=0)
    # the decode step writes its state: each side steps its own copy
    st = torch.randn(2, 4, 8, 16)
    st_plain = st.clone()
    sx, sdt = torch.randn(2, 4, 8), torch.rand(2, 4)
    sbc = torch.randn(2, 1, 16)
    torch.testing.assert_close(
        ops.ssd_step(sx, sdt, torch.ones(4), sbc, sbc, torch.ones(4), st),
        ssd_step_plain(sx, sdt, torch.ones(4), sbc, sbc, torch.ones(4),
                       st_plain), rtol=0, atol=0)
    assert torch.equal(st, st_plain)
    assert launch_counts() == {"rmsnorm": 0, "rmsnorm_fused": 0,
                               "flash_attention": 0, "decode_attention": 0,
                               "ssd_scan": 0, "rglru_scan": 0,
                               "mla_decode": 0, "mla_decode_wide": 0,
                               "ssd_step": 0, "rglru_gated": 0,
                               "rglru_gated_step": 0}


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
    with pytest.raises(ValueError):
        ops.rglru_gated_scan(q[0], q[0], q[0], q[0, 0, 0], q[0], q[0, 0])
    step = [torch.empty(shape, device="meta") for shape in
            ((2, 4, 8), (2, 4), (4,), (2, 1, 16), (2, 1, 16), (4,),
             (2, 4, 8, 16))]
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.ssd_step(*step)


@pytest.mark.parametrize("b,s,chunk,blocks,stages", [
    (1, 64, 64, 128, 1),       # the 64-token bucket: 2 slices of 32
    (1, 256, 128, 256, 1),     # chunk 128: only slices of 16 fit
    (8, 64, 64, 512, 1),       # batch 8: one slice of all of P
    (1, 128, 32, 128, 2)])     # several chunks, two stages fit one wave
def test_ssd_plan_fills_the_card(b, s, chunk, blocks, stages):
    """At mamba2-1.3b's heads (64 of P 64, N 128, one group) on 132 SMs:
    at least 128 blocks at batch 1, clusters of 8 blocks sharing C.B^T, and
    a block's shared memory within the card's."""
    ps, st, cluster = ssd.plan(b, s, 64, 64, 1, 128, chunk, 132)
    assert b * 64 * -(-64 // ps) == blocks and ps % 16 == 0
    assert (st, cluster) == (stages, 8)
    assert ssd.smem_bytes(chunk, 128, ps, st) <= ssd.SMEM_BLOCK


@pytest.mark.parametrize("p", [8, 24, 48, 64, 96, 128])
def test_ssd_plan_slices_are_powers_of_two(p):
    """The kernel indexes a slice with shifts: every P gets a power-of-two
    slice of at least 16 (a P that none divides is padded with zeros)."""
    for b, h in ((1, 64), (8, 64), (1, 4)):
        ps = ssd.plan(b, 64, h, p, 1, 128, 64, 132)[0]
        assert ps >= 16 and ps & (ps - 1) == 0


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


# ---------------------------------------------------------------------------
# the bf16 kernels' rounding (CPU emulation) against the Pallas kernels
# ---------------------------------------------------------------------------

def _mma_attention(q, k, v, live, *, prescale_q=False, split_p=True):
    """The bf16 attention kernels' arithmetic (csrc/flash_attention.cu,
    csrc/decode_attention.cu): bf16 q and k multiplied exactly and summed
    in fp32, the D^-0.5 scale applied to the fp32 scores, the softmax in
    fp32, and P entering P.V as hi = bf16(P) plus lo = bf16(P - hi) against
    bf16 V, the output rounded once. ``prescale_q`` rounds q * D^-0.5 to
    bf16 before the product instead; ``split_p=False`` takes one bf16 P.
    q (B,S,H,D); k, v (B,T,Hkv,D); live broadcasts to (B,Hkv,G,S,T)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, D).float()
    if prescale_q:
        qg = (qg * D ** -0.5).bfloat16().float()
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.float())
    if not prescale_q:
        s = s * D ** -0.5
    s = torch.where(live, s, -1e30)
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    hi = p.bfloat16().float()
    parts = [hi, (p - hi).bfloat16().float()] if split_p else [hi]
    out = sum(torch.einsum("bhgst,bthd->bshgd", x, v.float())
              for x in parts)
    l = p.sum(-1).permute(0, 3, 1, 2)[..., None]
    out = out / torch.where(l == 0.0, 1.0, l)
    return out.reshape(B, S, H, D).to(q.dtype)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _mma_case(kind, B, T, H, Hkv, D):
    """(the Pallas kernel's bf16 output, the emulation's inputs) on numpy
    inputs: decode with prefix validity, or causal prefill (S = T)."""
    if kind == "decode":
        q, kc, vc, valid = _decode_inputs(14, B, T, H, Hkv, D)
        jargs = (_jax(q, "bfloat16"), _jax(kc, "bfloat16"),
                 _jax(vc, "bfloat16"), jnp.asarray(valid))
        want = jops.decode_attention(*jargs)
        live = torch.from_numpy(valid)[:, None, None, None, :]
    else:
        q, kc, vc = _normal(15, (B, T, H, D), (B, T, Hkv, D), (B, T, Hkv, D))
        want = jops.flash_attention(_jax(q, "bfloat16"), _jax(kc, "bfloat16"),
                                    _jax(vc, "bfloat16"), causal=True)
        live = torch.tril(torch.ones(T, T, dtype=torch.bool))
    return want, (_torch(q, "bfloat16"), _torch(kc, "bfloat16"),
                  _torch(vc, "bfloat16"), live)


MMA_CASES = [("decode", 2, 512, 6, 2, 128),    # llama3-3b's group and D
             ("decode", 2, 512, 16, 1, 256),   # recurrentgemma-9b's
             ("decode", 2, 256, 6, 2, 64),
             ("flash", 1, 64, 6, 2, 128)]      # llama3-3b's prefill bucket


@pytest.mark.parametrize("kind,B,T,H,Hkv,D", MMA_CASES)
def test_mma_rounding_matches_pallas(kind, B, T, H, Hkv, D):
    """The kernels' bf16 scheme lies within the relative L2 of 1e-3 that
    ``chip_smoke.py`` and the card tests hold the kernels to, against the
    Pallas kernels in interpret mode on the same bf16 inputs."""
    want, args = _mma_case(kind, B, T, H, Hkv, D)
    assert _rel_l2(_mma_attention(*args).float().numpy(), want) <= 1e-3


@pytest.mark.parametrize("kind,B,T,H,Hkv,D",
                         [c for c in MMA_CASES if c[-1] == 128])
def test_mma_rounding_shortcuts_miss_the_check(kind, B, T, H, Hkv, D):
    """Why the kernels keep the scale in fp32 and split P: at head_dim 128
    (D^-0.5 is no power of two) q pre-scaled in bf16 misses 1e-3, and so
    does one bf16 P at every head_dim."""
    want, args = _mma_case(kind, B, T, H, Hkv, D)
    for shortcut in (dict(prescale_q=True), dict(split_p=False)):
        got = _mma_attention(*args, **shortcut).float().numpy()
        assert _rel_l2(got, want) > 1e-3, shortcut


# ---------------------------------------------------------------------------
# the SSD kernel's 3xTF32 products (CPU emulation) against the Pallas kernel
# ---------------------------------------------------------------------------

def _tf32(t, rounded=True):
    """fp32 to TF32, the low 13 mantissa bits cleared: rounded to nearest
    with ties away from zero (as ``cvt.rna.tf32.f32`` rounds), or
    truncated."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000 if rounded else i) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b on TF32 tensor cores with fp32 sums: one pass (hi . hi), or
    the kernel's three (hi . hi + (hi . lo + lo . hi), hi rounded, lo the
    remainder of each operand truncated to TF32)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah, rounded=False), _tf32(b - bh, rounded=False)
    return ah @ bh + (ah @ bl + al @ bh)


def _ssd_tf32(x, dt, A, B, C, chunk, passes):
    """The arithmetic of ``csrc/ssd_scan.cu``: seg summed in fp64, the four
    products C.B^T, att.x, C.S_prev^T and (x * w)^T.B through
    ``_mm_tf32``, everything else in fp32. Shapes as ``ssd_scan``."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    state = torch.zeros(b, h, p, B.shape[3])
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    ys = []
    for t0 in range(0, s, chunk):
        def heads(t):
            return t[:, t0:t0 + chunk].transpose(1, 2)
        xc = heads(x)
        Bc = heads(B).repeat_interleave(rep, 1)
        Cc = heads(C).repeat_interleave(rep, 1)
        dtc = dt[:, t0:t0 + chunk].transpose(1, 2)
        seg = torch.cumsum((dtc * A[None, :, None]).double(), -1)
        decay = torch.exp(-(seg[..., :, None] - seg[..., None, :]).float())
        cb = _mm_tf32(Cc, Bc.transpose(-1, -2), passes)
        att = torch.where(causal, cb * decay * dtc[..., None, :], 0.0)
        y = _mm_tf32(att, xc, passes)
        if t0:
            y = y + torch.exp(-seg.float())[..., None] * _mm_tf32(
                Cc, state.transpose(-1, -2), passes)
        ys.append(y.transpose(1, 2))
        last = seg[..., -1:]
        w = torch.exp(-(last - seg).float()) * dtc
        state = torch.exp(-last.float())[..., None] * state + _mm_tf32(
            (xc * w[..., None]).transpose(-1, -2), Bc, passes)
    return torch.cat(ys, 1), state


@pytest.mark.parametrize("s,chunk", [(128, 64), (256, 128)])
def test_ssd_3xtf32_matches_pallas(s, chunk):
    """At mamba2-1.3b's shape and decay rates (A = linspace(1, 16) over 64
    heads of P 64, N 128, one group), the 3xTF32 products lie within the
    SSD tolerance of 2e-4 of the Pallas kernel (interpret mode); one-pass
    TF32 misses it, which is why the kernel splits every operand."""
    b, h, p, g, n = 1, 64, 64, 1, 128
    rng = np.random.default_rng(20)
    f = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f)
    A = np.linspace(1.0, 16.0, h).astype(f)
    B = (0.5 * rng.standard_normal((b, s, g, n))).astype(f)
    C = (0.5 * rng.standard_normal((b, s, g, n))).astype(f)
    want = ssd_scan_kernel(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                           chunk=chunk, interpret=True)
    args = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    for got, ref in zip(_ssd_tf32(*args, chunk, passes=3), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)
    y1 = _ssd_tf32(*args, chunk, passes=1)[0].numpy()
    y_ref = np.asarray(want[0])
    assert not np.allclose(y1, y_ref, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the RG-LRU kernel's chunk order (CPU emulation) against the Pallas kernel
# ---------------------------------------------------------------------------

RGLRU_SWEEP = [(1, 64, 128), (2, 256, 256), (3, 128, 384)]


def _rglru_chunked(x, log_a, h0, p):
    """The arithmetic of ``csrc/rglru_scan.cu`` under plan ``p``: each chunk
    of ``rglru.chunk_bounds`` scanned from zero with the running product of
    a, the chunks of a time tile folded in order onto its incoming state for
    each chunk's carry, each step fixed up as local + product * carry, and
    the tile's end state carried to the next tile. Products and sums are
    rounded apart, as the kernel rounds them."""
    a = torch.exp(log_a)
    gx = torch.sqrt(torch.clamp(1.0 - a * a, 1e-9, 1.0)) * x
    ys = torch.empty_like(x)
    h = h0.clone()
    T = p.chunk * p.chunks
    bounds = lru.chunk_bounds(x.shape[1], p)
    for t0 in range(0, x.shape[1], T):
        tile = []
        for s, e in (b for b in bounds if t0 <= b[0] < t0 + T):
            loc, prod, steps = gx[:, s], a[:, s], []
            steps.append((loc, prod))
            for t in range(s + 1, e):
                loc = a[:, t] * loc + gx[:, t]
                prod = prod * a[:, t]
                steps.append((loc, prod))
            tile.append((s, steps))
        for s, steps in tile:
            cin = h
            for t, (loc, prod) in enumerate(steps, start=s):
                ys[:, t] = prod * cin + loc
            loc, prod = steps[-1]
            h = prod * h + loc
    return ys, h


@pytest.mark.parametrize("B,S,W", RGLRU_SWEEP + [(1, 64, 4096)])
def test_rglru_chunked_order_matches_pallas(B, S, W):
    """The kernel's order of sums, at the plan the card gets, lies within
    the scan's 1e-5 of the Pallas kernel (interpret mode), and its h_last is
    its last y bit for bit, as the kernel's is."""
    rng = np.random.default_rng(30)
    f = np.float32
    x = rng.standard_normal((B, S, W)).astype(f)
    log_a = (-np.log1p(np.exp(rng.standard_normal((B, S, W))))).astype(f)
    h0 = rng.standard_normal((B, W)).astype(f)
    want = jops.rglru_scan(*(jnp.asarray(v) for v in (x, log_a, h0)))
    p = lru.plan(B, S, W)
    ys, hl = _rglru_chunked(*(torch.from_numpy(v) for v in (x, log_a, h0)),
                            p)
    for got, ref in zip((ys, hl), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    assert torch.equal(hl, ys[:, -1])


@pytest.mark.parametrize("B,S,W", [(1, 64, 4096), (8, 1, 4096),
                                   (1, 2, 4096), (1, 3, 4096),
                                   (1, 256, 4096), (2, 300, 4096),
                                   (3, 37, 130)] + RGLRU_SWEEP)
def test_rglru_plan_fills_the_card_and_tiles_time(B, S, W):
    """On 132 SMs: at batch 1, 64 tokens and recurrentgemma-9b's width, at
    least 128 blocks (two an SM); every plan within the kernel's limits,
    and its chunks tile S exactly, in order, each at most a chunk long."""
    p = lru.plan(B, S, W, 132)
    if (B, S, W) == (1, 64, 4096):
        assert p.blocks(B, W) >= 128 and p.threads >= 128
    assert 1 <= p.tile_w <= lru.MAX_TILE_W and p.chunk in (1, 2, 4)
    assert p.threads <= lru.MAX_THREADS
    bounds = lru.chunk_bounds(S, p)
    assert bounds[0][0] == 0 and bounds[-1][1] == S
    assert all(e0 == s1 for (_, e0), (s1, _) in zip(bounds, bounds[1:]))
    assert all(0 < e - s <= p.chunk for s, e in bounds)
