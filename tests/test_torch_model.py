"""The port's dense decoder LM against ``repro.models`` on the same weights:
the JAX init, exported as numpy arrays and converted by
``repro_torch.models.convert``. Configs: reduced tinyllama, reduced
llama3-3b, a GQA variant of it with 6 query heads over 2 kv heads (group
3, as the full llama3-3b has), and the reduced phi3, nemotron, starcoder2
and chameleon configs. All in fp32 on the CPU.

Tolerances: logits 5e-4 against JAX, with ``use_pallas`` off and on (the
model-with-kernels tolerance of ``tests/test_kernels.py``); prefill vs
forward 2e-4 and decode vs forward 1e-3 (``tests/test_models_smoke.py``);
decode steps against JAX's 1e-3; scatter vs onehot 1e-5
(``tests/test_perf_variants.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.attention import init_kv_cache as jax_init_kv_cache
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.attention import init_kv_cache
from repro_torch.models.convert import from_jax_params

VARIANTS = {
    "tinyllama": ("tinyllama-1.1b", {}),
    "llama3": ("llama3-3b", {}),
    "llama3-gqa3": ("llama3-3b", dict(num_heads=6, num_kv_heads=2)),
    # the other dense families: squared-relu, tanh-gelu, qk-norm FFN/attn
    "phi3": ("phi3-medium-14b", {}),
    "nemotron": ("nemotron-4-15b", {}),
    "starcoder2": ("starcoder2-7b", {}),
    "chameleon": ("chameleon-34b", {}),
}


def _configs(name, **extra):
    arch, kw = VARIANTS[name]
    kw = dict(kw, **extra)
    return (jax_get_config(arch).reduced().replace(**kw),
            get_config(arch).reduced().replace(**kw))


def _models(name, **extra):
    jcfg, tcfg = _configs(name, **extra)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, params),
                              device="cpu")
    return jm, params, build_model(tcfg), tparams, tcfg


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_jax(name, use_pallas):
    jm, params, tm, tparams, cfg = _models(name, use_pallas=use_pallas)
    toks = _tokens(cfg, (2, 32))
    jl, _ = jm.forward(params, jnp.asarray(toks))
    tl, aux = tm.forward(tparams, torch.from_numpy(toks))
    assert tl.shape == (2, 32, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_prefill_decode_matches_forward(name):
    _, _, tm, tparams, cfg = _models(name)
    B, S, CAP = 2, 12, 32
    toks = torch.from_numpy(_tokens(cfg, (B, S + 1)))
    full, _ = tm.forward(tparams, toks)
    pl, cache = tm.prefill(tparams, toks[:, :S], max_len=CAP)
    np.testing.assert_allclose(pl[:, 0].numpy(), full[:, S - 1].numpy(),
                               rtol=2e-4, atol=2e-4)
    assert cache["scanned"].k.shape == (cfg.num_layers, B, CAP,
                                        cfg.num_kv_heads, cfg.head_dim)
    pos = torch.full((B,), S, dtype=torch.long)
    dl, new_cache = tm.decode_step(tparams, toks[:, S:S + 1], cache, pos)
    np.testing.assert_allclose(dl[:, 0].numpy(), full[:, S].numpy(),
                               rtol=1e-3, atol=1e-3)
    assert new_cache is cache          # the cache is updated in place


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_ragged_decode_steps_match_jax(name):
    """Four decode steps from an empty cache at ragged positions."""
    jm, params, tm, tparams, cfg = _models(name)
    B, CAP = 3, 16
    jcache = jm.init_cache(B, CAP)
    tcache = tm.init_cache(B, CAP, device="cpu")
    pos = np.array([0, 5, 11])
    toks = _tokens(cfg, (4, B, 1), seed=2)
    for i in range(4):
        jl, jcache = jm.decode_step(params, jnp.asarray(toks[i]), jcache,
                                    jnp.asarray(pos + i, jnp.int32))
        tl, tcache = tm.decode_step(tparams, torch.from_numpy(toks[i]),
                                    tcache, torch.from_numpy(pos + i))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tcache["scanned"].k.numpy(),
                               np.asarray(jcache["scanned"].k),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_scatter_matches_onehot_decode(name):
    _, _, _, tparams, cfg = _models(name)
    m1 = build_model(cfg.replace(kv_update="onehot"))
    m2 = build_model(cfg.replace(kv_update="scatter"))
    B, S, CAP = 2, 8, 16
    toks = torch.from_numpy(_tokens(cfg, (B, S)))
    _, c1 = m1.prefill(tparams, toks, max_len=CAP)
    _, c2 = m2.prefill(tparams, toks, max_len=CAP)
    pos = torch.full((B,), S, dtype=torch.long)
    for i in range(4):
        d1, c1 = m1.decode_step(tparams, toks[:, :1], c1, pos + i)
        d2, c2 = m2.decode_step(tparams, toks[:, :1], c2, pos + i)
        np.testing.assert_allclose(d1.numpy(), d2.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_sliding_window_cache_matches_jax():
    """The ring-buffer cache of a windowed config: prefill past the window
    (the roll), then decode steps that wrap it."""
    jm, params, tm, tparams, cfg = _models("llama3-gqa3",
                                           attention_window=8)
    B, S = 2, 11
    toks = _tokens(cfg, (B, S + 3))
    jl, jcache = jm.prefill(params, jnp.asarray(toks[:, :S]))
    tl, tcache = tm.prefill(tparams, torch.from_numpy(toks[:, :S]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(tcache["scanned"].k.numpy(),
                               np.asarray(jcache["scanned"].k),
                               rtol=1e-4, atol=1e-4)
    for i in range(3):
        pos = np.full((B,), S + i)
        jl, jcache = jm.decode_step(params, jnp.asarray(toks[:, S + i:][:, :1]),
                                    jcache, jnp.asarray(pos, jnp.int32))
        tl, tcache = tm.decode_step(tparams,
                                    torch.from_numpy(toks[:, S + i:][:, :1]),
                                    tcache, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=1e-3, atol=1e-3)


def test_unported_families_raise():
    for arch in ("deepseek-v2-lite-16b", "llama4-scout-17b-a16e",
                 "whisper-medium"):
        with pytest.raises(NotImplementedError):
            build_model(get_config(arch).reduced())
    cfg = get_config("tinyllama-1.1b").reduced().replace(
        ref_attention="chunked")
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        m.forward(params, torch.zeros((1, 1024), dtype=torch.long))


def test_init_is_seeded_and_shaped():
    cfg = get_config("llama3-3b").reduced()
    m = build_model(cfg)
    a = m.init(torch.Generator().manual_seed(3))
    b = m.init(torch.Generator().manual_seed(3))
    assert len(a["layers"]) == cfg.num_layers
    assert a["layers"][0]["attn"]["wq"].shape == (
        cfg.d_model, cfg.num_heads * cfg.head_dim)
    assert a["lm_head"].shape == (cfg.d_model, cfg.vocab_size)
    torch.testing.assert_close(a["embed"], b["embed"], rtol=0, atol=0)
    # truncated normal at 2 sigma, scaled by 1/sqrt(fan_in)
    w = a["layers"][0]["ffn"]["w_in"]
    assert float(w.abs().max()) <= 2.0 * cfg.d_model ** -0.5 + 1e-6
    # per-layer caches as the JAX package shapes them (window: ring length)
    jcfg = jax_get_config("llama3-3b").reduced()
    for kw in ({}, dict(attention_window=8)):
        ours = init_kv_cache(cfg.replace(**kw), 2, 16, device="cpu")
        ref = jax_init_kv_cache(jcfg.replace(**kw), 2, 16)
        assert ours.k.shape == ref.k.shape and ours.v.dtype == torch.float32


def test_convert_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tree = {"embed": np.zeros((4, 2), np.float32),
            "layers": {"w": np.zeros((2, 3), np.float32)}}
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params(tree)
    out = from_jax_params(tree, device="cpu")
    assert len(out["layers"]) == 2 and out["embed"].device.type == "cpu"
