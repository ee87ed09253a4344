"""The port's encoder-decoder (``repro_torch.models.encdec.EncDecLM``) and
its parts against ``repro.models`` on the same weights: the JAX init,
exported as numpy arrays and converted by ``repro_torch.models.convert``.
Reduced whisper-medium (2 encoder + 2 decoder layers, d_model 256, 4 heads
of 64, 16 frames), fp32 on the CPU, inputs from a seeded numpy generator.

Tolerances: LayerNorm 1e-6 (fp32 sums in another order); the sinusoids
1e-6 beyond what one ULP of an inverse timescale moves an angle by (below);
``encoder_kv`` and ``cross_attention`` 2e-5 (the kernels' fp32 tolerance of
``tests/test_kernels.py``); ``encode`` and the logits 5e-4 against JAX,
with ``use_pallas`` off and on (the model-with-kernels tolerance); the
prefill caches 1e-4 (as ``tests/test_torch_model.py``); decode steps 1e-3;
prefill vs forward 2e-4 and decode vs forward 1e-3
(``tests/test_models_smoke.py``).

The inverse timescales exp(-i log(10000) / (dim/2 - 1)) are fp32 in both
frameworks, and XLA's fp32 ``exp`` on the CPU is not correctly rounded: at
dim 1024 it is one ULP off the float64 value in 59 of the 512 (PyTorch's in
3). A sinusoid's angle t * inv multiplies that ULP by t, up to 1499 at
whisper's 1500 frames: 1.2e-4. So the inverse timescales are held to JAX's
within one ULP, and the sinusoids to JAX's at 1e-6 beyond the difference of
the two fp32 angles (none where the two inverse timescales agree).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models.common import layer_norm as jax_layer_norm
from repro.models.common import sinusoidal_positions as jax_sinusoids
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import build_model, tree_clone, tree_tensors
from repro_torch.models.common import (inverse_timescales, layer_norm,
                                       sinusoidal_positions, sinusoids)
from repro_torch.models.convert import from_jax_params
from repro_torch.models.encdec import EncDecLM
from repro_torch.serving.engine import _decode_body
from repro_torch.serving.graphs import StepGraph

ARCH = "whisper-medium"
B, S, CAP = 2, 12, 32


def _models(**kw):
    jcfg = jax_get_config(ARCH).reduced().replace(**kw)
    cfg = get_config(ARCH).reduced().replace(**kw)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, params),
                              device="cpu")
    return jm, params, build_model(cfg), tparams, cfg


def _inputs(cfg, seed=1):
    """(tokens (B, S + 3), frames (B, encoder_seq, d_model)) as numpy."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
    return (rng.integers(0, cfg.vocab_size, (B, S + 3)),
            frames.astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _shapes(tree, path=""):
    """{leaf path: shape} of a params tree of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return {path: tuple(tree.shape)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{path}/{k}"))
    return out


def test_layer_norm_matches_jax():
    """Rows with a mean of 3: the population variance (an unbiased one is
    off by (n-1)/n), at whisper's default eps of 1e-5."""
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.standard_normal((4, 8, 256))).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    b = (0.1 * rng.standard_normal(256)).astype(np.float32)
    got = layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    _close(got, jax_layer_norm(x, w, b), 1e-6)
    ref = torch.nn.functional.layer_norm(torch.from_numpy(x), (256,),
                                         torch.from_numpy(w),
                                         torch.from_numpy(b), eps=1e-5)
    _close(got, ref, 1e-5)


def test_sinusoidal_positions_match_jax():
    T, d = 1500, 1024
    lt = jnp.log(10000.0) / (d // 2 - 1)
    inv_jax = np.asarray(jnp.exp(-lt * jnp.arange(d // 2,
                                                  dtype=jnp.float32)))
    inv = inverse_timescales(d, "cpu").numpy()
    np.testing.assert_array_max_ulp(inv, inv_jax, maxulp=1)
    got = sinusoidal_positions(T, d, "cpu").numpy()
    want = np.asarray(jax_sinusoids(T, d))
    assert got.shape == want.shape == (T, d) and got.dtype == np.float32
    # each framework's fp32 angles t * inv; equal where the two inv agree
    t = np.arange(T, dtype=np.float32)[:, None]
    moved = np.tile(np.abs((t * inv).astype(np.float64) - t * inv_jax), 2)
    assert np.all(np.abs(got - want) <= 1e-6 + moved)
    # a decode step's per-row sinusoids are the table's rows, bit for bit
    pos = torch.tensor([0, 7, 1499])
    assert torch.equal(sinusoids(pos, d), torch.from_numpy(got)[pos])


def test_cross_attention_matches_jax():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    p = jattn.init_cross_attention(jax.random.PRNGKey(3), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, p), device="cpu")
    assert set(tp) == {"wq", "wk", "wv", "wo"}
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    jk, jv = jattn.encoder_kv(p, jcfg, jnp.asarray(enc))
    k, v = attn.encoder_kv(tp, cfg, torch.from_numpy(enc))
    assert k.shape == (B, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    _close(k, jk, 2e-5)
    _close(v, jv, 2e-5)
    want = jattn.cross_attention(p, jcfg, jnp.asarray(x), jk, jv)
    _close(attn.cross_attention(tp, cfg, torch.from_numpy(x), k, v), want,
           2e-5)


def test_encode_matches_jax():
    jm, params, tm, tparams, cfg = _models()
    _, frames = _inputs(cfg)
    got = tm.encode(tparams, torch.from_numpy(frames))
    assert got.shape == frames.shape
    _close(got, jm.encode(params, jnp.asarray(frames)), 5e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_jax(use_pallas):
    jm, params, tm, tparams, cfg = _models(use_pallas=use_pallas)
    toks, frames = _inputs(cfg)
    jl, _ = jm.forward(params, jnp.asarray(toks), jnp.asarray(frames))
    tl, aux = tm.forward(tparams, torch.from_numpy(toks),
                         torch.from_numpy(frames))
    assert tl.shape == (B, S + 3, cfg.vocab_size) and float(aux) == 0.0
    _close(tl, jl, 5e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_jax(use_pallas):
    """Prefill logits and all three caches, then three decode steps."""
    jm, params, tm, tparams, cfg = _models(use_pallas=use_pallas)
    toks, frames = _inputs(cfg)
    jl, jc = jm.prefill(params, jnp.asarray(toks[:, :S]),
                        jnp.asarray(frames), max_len=CAP)
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks[:, :S]),
                        torch.from_numpy(frames), max_len=CAP)
    _close(tl, jl, 5e-4)
    assert tc["self"].k.shape == (cfg.num_layers, B, CAP, cfg.num_kv_heads,
                                  cfg.head_dim)
    for got, want in ((tc["self"].k, jc["self"].k),
                      (tc["self"].v, jc["self"].v),
                      (tc["cross_k"], jc["cross_k"]),
                      (tc["cross_v"], jc["cross_v"])):
        assert got.shape == want.shape
        _close(got, want, 1e-4)
    for i in range(3):
        pos = np.full((B,), S + i)
        tok = toks[:, S + i:S + i + 1]
        jl, jc = jm.decode_step(params, jnp.asarray(tok), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tparams, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        _close(tl, jl, 1e-3)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_decode_matches_forward(use_pallas):
    _, _, tm, tparams, cfg = _models(use_pallas=use_pallas)
    toks, frames = (torch.from_numpy(a) for a in _inputs(cfg))
    full, _ = tm.forward(tparams, toks[:, :S + 1], frames)
    pl, cache = tm.prefill(tparams, toks[:, :S], frames, max_len=CAP)
    _close(pl[:, 0], full[:, S - 1], 2e-4)
    dl, _ = tm.decode_step(tparams, toks[:, S:S + 1], cache,
                           torch.full((B,), S))
    _close(dl[:, 0], full[:, S], 1e-3)


def test_decode_step_writes_in_place_and_reads_the_cross_cache():
    _, _, tm, tparams, cfg = _models()
    toks, frames = (torch.from_numpy(a) for a in _inputs(cfg))
    _, cache = tm.prefill(tparams, toks[:, :S], frames, max_len=CAP)
    before = tree_clone(cache)
    ptrs = [t.data_ptr() for t in tree_tensors(cache)]
    _, out = tm.decode_step(tparams, toks[:, S:S + 1], cache,
                            torch.full((B,), S))
    assert out is cache
    assert [t.data_ptr() for t in tree_tensors(out)] == ptrs
    assert torch.equal(out["cross_k"], before["cross_k"])
    assert torch.equal(out["cross_v"], before["cross_v"])
    # the self cache changed at slot S alone, in every layer
    for new, old in zip(out["self"], before["self"]):
        assert torch.equal(new[:, :, :S], old[:, :, :S])
        assert torch.equal(new[:, :, S + 1:], old[:, :, S + 1:])
        assert bool((new[:, :, S] != 0).any()) and \
            bool((old[:, :, S] == 0).all())


def test_decode_body_through_step_graph_matches_decode_step():
    """The decode step as a ``StepGraph`` on static token, pos and cache
    (eager on the CPU; captured on the card) against ``decode_step`` on a
    clone of the cache, bit for bit over three greedy steps."""
    _, _, tm, tparams, cfg = _models()
    toks, frames = (torch.from_numpy(a) for a in _inputs(cfg))
    _, cache = tm.prefill(tparams, toks[:, :S], frames, max_len=CAP)
    static = tm.init_cache(B, CAP, device="cpu")
    for dst, src in zip(tree_tensors(static), tree_tensors(cache)):
        dst.copy_(src)
    token = toks[:, S:S + 1].clone()
    pos = torch.full((B,), S)
    graph = StepGraph(functools.partial(_decode_body, tm, tparams, token,
                                        static, pos), torch.device("cpu"))
    assert graph.graph is None
    with torch.no_grad():
        for _ in range(3):
            want, cache = tm.decode_step(tparams, token.clone(), cache,
                                         pos.clone())
            got = graph()
            assert torch.equal(got, want)
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_tensors(static), tree_tensors(cache)))
            token.copy_(got.argmax(-1))
            pos += 1


def test_init_is_seeded_and_shaped():
    cfg = get_config(ARCH).reduced()
    m = build_model(cfg)
    assert isinstance(m, EncDecLM)
    a = m.init(torch.Generator().manual_seed(3))
    b = m.init(torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(tree_tensors(a),
                                                tree_tensors(b)))
    # the JAX tree's leaves, leaf for leaf (its layers stacked)
    jm = jax_build_model(jax_get_config(ARCH).reduced())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    conv = from_jax_params(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), device="cpu")
    assert len(a["enc_layers"]) == cfg.encoder_layers
    assert len(a["dec_layers"]) == cfg.num_layers
    assert _shapes(a) == _shapes(conv)
    assert sum(t.numel() for t in tree_tensors(a)) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    ln = a["dec_layers"][0]["cross_norm"]
    assert torch.equal(ln["w"], torch.ones(cfg.d_model)) and \
        torch.equal(ln["b"], torch.zeros(cfg.d_model))
    ours = m.init_cache(B, CAP, device="cpu")
    ref = jm.init_cache(B, CAP)
    assert [t.shape for t in tree_tensors(ours)] == \
        [tuple(x.shape) for x in (ref["self"].k, ref["self"].v,
                                  ref["cross_k"], ref["cross_v"])]
