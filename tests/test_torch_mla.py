"""The port's MLA (DeepSeek-V2's multi-head latent attention) and its
chunked attention reference against ``repro.models.attention``, on the CPU
in fp32; inputs from a numpy seed, weights from the JAX init converted by
``repro_torch.models.convert``.

Tolerances: the ports of ``tests/test_perf_variants.py::TestChunkedAttention``
keep its own (1e-5 against the naive paths, 1e-6 between the streaming
forms, 3e-4 between a model's chunked and naive paths), and of
``::TestScatterKV`` (1e-5); MLA's forward against JAX's at the model
tolerance of ``tests/test_models_smoke.py`` (5e-4), and its decode steps at
its decode tolerance (1e-3), the cache at 1e-4 as the dense model tests
hold theirs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models.attention as attention_mod
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models.common import apply_rope as jax_apply_rope
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import build_model
from repro_torch.models.attention import (flash_attention_chunked,
                                          gqa_attention)
from repro_torch.models.common import apply_rope, model_rope
from repro_torch.models.convert import from_jax_params

DEEPSEEK = "deepseek-v2-lite-16b"


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# the chunked reference (ports of TestChunkedAttention)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,Hkv,D,block", [
    (2, 256, 4, 2, 64, 64),
    (1, 200, 4, 1, 32, 64),       # non-multiple of block
    (2, 128, 8, 8, 64, 32),
])
def test_chunked_matches_naive_causal(B, S, H, Hkv, D, block):
    q, k, v = _t(*_normal(0, (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    a = flash_attention_chunked(q, k, v, causal=True, block_k=block)
    b = ref.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_chunked_matches_naive_banded():
    q, k, v = _t(*_normal(1, (2, 256, 4, 64), (2, 256, 2, 64),
                          (2, 256, 2, 64)))
    i = torch.arange(256)[:, None]
    j = torch.arange(256)[None, :]
    band = (j <= i) & (j > i - 64)
    a = flash_attention_chunked(q, k, v, causal=True, window=64, block_k=64)
    b = gqa_attention(q, k, v, band[None, None])
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("unroll", [False, True])
def test_chunked_matches_jax_streaming(unroll):
    """The port of ``test_unrolled_matches_scan``: the port's loop over key
    blocks against JAX's streaming form, its ``lax.scan`` and its unrolled
    loop, at that test's 1e-6; ragged, banded and causal."""
    q, k, v = _normal(2, (1, 136, 2, 32), (1, 136, 2, 32), (1, 136, 2, 32))
    for causal, window in ((True, 0), (True, 48), (False, 0)):
        a = flash_attention_chunked(*_t(q, k, v), causal=causal,
                                    window=window, block_k=32)
        b = jattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window, block_k=32,
                                      unroll=unroll)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_chunked_mixed_value_head_dim():
    """Dv != Dk (the MLA folding case)."""
    q, k, v = _t(*_normal(3, (1, 64, 4, 48), (1, 64, 4, 48),
                          (1, 64, 4, 32)))
    a = flash_attention_chunked(q, k, v, causal=True, block_k=16)
    s = torch.einsum("bshd,bthd->bhst", q, k) * (48 ** -0.5)
    mask = torch.tril(torch.ones((64, 64), dtype=torch.bool))
    s = torch.where(mask[None, None], s, -1e30)
    b = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), v)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_chunked_row_with_no_key_is_zero():
    """A query with no key in its window (the ``l == 0`` guard): 0, not a
    division by zero, as in JAX. A window of -4 keeps keys j > i + 4, so
    queries 3..7 of 8 have none."""
    q, k, v = _normal(4, (1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16))
    a = flash_attention_chunked(*_t(q, k, v), causal=False, window=-4,
                                block_k=4)
    b = jattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False, window=-4,
                                  block_k=4)
    assert float(a[:, 3:].abs().max()) == 0.0
    assert float(a[:, :3].abs().min()) > 0.0
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("arch", [DEEPSEEK, "chameleon-34b"])
def test_model_level_chunked_matches_naive(arch, monkeypatch):
    """Port of ``test_model_level_chunked_matches_naive``, and the port's
    chunked model against JAX's: 32 tokens past a threshold of 8."""
    monkeypatch.setattr(attention_mod, "CHUNKED_ATTENTION_MIN_SEQ", 8)
    monkeypatch.setattr(jattn, "CHUNKED_ATTENTION_MIN_SEQ", 8)
    jcfg = jax_get_config(arch).reduced().replace(ref_attention="chunked")
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    cfg = get_config(arch).reduced()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    l1, _ = build_model(cfg).forward(tparams, torch.from_numpy(toks))
    l2, _ = build_model(cfg.replace(ref_attention="chunked")).forward(
        tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=3e-4, atol=3e-4)
    jl, _ = jax_build_model(jcfg).forward(params, jnp.asarray(toks))
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl), rtol=5e-4,
                               atol=5e-4)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def test_rope_tables_take_the_width_attention_rotates():
    """MLA rotates ``qk_rope_head_dim`` channels, the dense models
    ``head_dim``; each model's tables rotate a vector as JAX's
    ``apply_rope`` does at that width."""
    pos = torch.arange(7)[None]
    for arch, width in ((DEEPSEEK, 16), ("llama3-3b", 64)):
        cfg = get_config(arch).reduced()
        rope = model_rope(cfg, pos)
        assert rope.sin.shape == (1, 7, 1, width // 2)
        x, = _normal(5, (1, 7, 3, width))
        np.testing.assert_allclose(
            apply_rope(torch.from_numpy(x), rope).numpy(),
            np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      cfg.rope_theta)),
            rtol=1e-6, atol=1e-6)


def _mla():
    jcfg = jax_get_config(DEEPSEEK).reduced()
    cfg = get_config(DEEPSEEK).reduced()
    p = jattn.init_mla(jax.random.PRNGKey(0), jcfg)
    return p, jcfg, from_jax_params(jax.tree.map(np.asarray, p),
                                    device="cpu"), cfg


def test_mla_forward_matches_jax():
    """``mla_forward`` over 24 tokens: output and the latent cache padded
    to 32 slots."""
    p, jcfg, tp, cfg = _mla()
    x, = _normal(6, (2, 24, cfg.d_model))
    positions = np.broadcast_to(np.arange(24), (2, 24))
    jy, jc = jattn.mla_forward(p, jcfg, jnp.asarray(x),
                               jnp.asarray(positions), cache_len=32)
    ty, tc = attention_mod.mla_forward(
        tp, cfg, torch.from_numpy(x),
        model_rope(cfg, torch.from_numpy(positions.copy())), cache_len=32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=5e-4,
                               atol=5e-4)
    assert tc.c_kv.shape == (2, 32, cfg.kv_lora_rank)
    for t, j in zip(tc, jc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("kv_update", ["onehot", "scatter"])
def test_mla_decode_matches_jax(kv_update):
    """``mla_decode``, four steps at ragged positions from a random cache
    (a row at the last slot, which it overwrites, as JAX clamps it), the
    cache written in place."""
    p, jcfg, tp, cfg = _mla()
    jcfg, cfg = (c.replace(kv_update=kv_update) for c in (jcfg, cfg))
    B, T = 3, 16
    c_kv, k_rope, xs = _normal(7, (B, T, cfg.kv_lora_rank),
                               (B, T, cfg.qk_rope_head_dim),
                               (4, B, 1, cfg.d_model))
    jc = jattn.MLACache(jnp.asarray(c_kv), jnp.asarray(k_rope))
    tc = attention_mod.MLACache(*_t(c_kv.copy(), k_rope.copy()))
    pos = np.array([0, 7, 14])
    for i in range(4):
        jy, jc = jattn.mla_decode(p, jcfg, jnp.asarray(xs[i]), jc,
                                  jnp.asarray(pos + i, jnp.int32))
        tpos = torch.from_numpy(pos + i)
        slots = attention_mod.decode_slots(cfg, T, tpos)
        ty, out = attention_mod.mla_decode(tp, cfg, torch.from_numpy(xs[i]),
                                           tc, slots,
                                           model_rope(cfg, tpos[:, None]))
        assert all(a is b for a, b in zip(out, tc))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-3,
                                   atol=1e-3)
    for t, j in zip(tc, jc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


def test_scatter_matches_onehot_decode_deepseek():
    """Port of ``TestScatterKV::test_scatter_matches_onehot_decode``, its
    deepseek case: four decode steps after an 8-token prefill into 16
    slots, both ``kv_update`` modes."""
    cfg = get_config(DEEPSEEK).reduced()
    m1 = build_model(cfg.replace(kv_update="onehot"))
    m2 = build_model(cfg.replace(kv_update="scatter"))
    params = m1.init(torch.Generator().manual_seed(0))
    B, S, CAP = 2, 8, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)))
    _, c1 = m1.prefill(params, toks, max_len=CAP)
    _, c2 = m2.prefill(params, toks, max_len=CAP)
    pos = torch.full((B,), S, dtype=torch.long)
    for i in range(4):
        d1, c1 = m1.decode_step(params, toks[:, :1], c1, pos + i)
        d2, c2 = m2.decode_step(params, toks[:, :1], c2, pos + i)
        np.testing.assert_allclose(d1.numpy(), d2.numpy(), rtol=1e-5,
                                   atol=1e-5)
