"""The port's MoE blocks and the MoE models (deepseek-v2-lite-16b and
llama4-scout-17b-a16e) against ``repro.models`` on the same weights: the
JAX init, exported as numpy arrays and converted by
``repro_torch.models.convert``. Reduced configs, fp32, on the CPU; inputs
from a numpy seed.

Tolerances: the MoE functions (dense and capacity dispatch, and capacity
0.5, which drops) at the fp32 kernel tolerance of ``tests/test_kernels.py``
(2e-5), their auxiliary losses too; the ports of
``tests/test_perf_variants.py::TestCapacityMoE`` at its own (capacity
against dense 2e-4, load balance 1e-4); whole models as
``tests/test_models_smoke.py`` holds them: logits 5e-4 against JAX with
``use_pallas`` off and on, prefill against forward 2e-4, decode against
forward and against JAX's decode steps 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import blocks as jblocks
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.models import blocks, build_model, tree_tensors
from repro_torch.models.convert import from_jax_params, to_tensor

ARCHS = ["deepseek-v2-lite-16b", "llama4-scout-17b-a16e"]
F32 = dict(rtol=2e-5, atol=2e-5)


def _moe(arch, **kw):
    """The JAX MoE block's params and config, and the port's of the same
    weights."""
    jcfg = jax_get_config(arch).reduced().replace(**kw)
    cfg = get_config(arch).reduced().replace(**kw)
    p = jblocks.init_moe(jax.random.PRNGKey(0), jcfg)
    return p, jcfg, from_jax_params(jax.tree.map(np.asarray, p),
                                    device="cpu"), cfg


def _x(cfg, shape, seed=1):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def _jax_keep(top_idx, E, C):
    """The capacity dispatch's kept assignments, from JAX's routing, in
    numpy: each assignment's arrival-order rank within its expert < C."""
    e = np.asarray(top_idx).reshape(-1)
    rank = np.array([np.sum(e[:i] == e[i]) for i in range(len(e))])
    return rank < C


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dispatch,factor", [("dense", 1.25),
                                             ("capacity", 1.25),
                                             ("capacity", 0.5)])
def test_moe_matches_jax(arch, dispatch, factor):
    """``moe_forward`` against JAX's at fp32 2e-5, output and both
    auxiliary losses; capacity 0.5 drops assignments, and the port keeps
    the same ones."""
    p, jcfg, tp, cfg = _moe(arch, moe_dispatch=dispatch,
                            capacity_factor=factor)
    x = _x(cfg, (2, 24))
    jy, jaux = jblocks.moe_forward(p, jcfg, jnp.asarray(x))
    ty, taux = blocks.moe_forward(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    for a, b in zip(taux, jaux):
        np.testing.assert_allclose(float(a), float(b), **F32)
    if dispatch == "capacity":
        N, E, K = 2 * 24, cfg.num_experts, cfg.top_k
        C = max(int(-(-N * K // E) * factor), 1)
        probs = jax.nn.softmax((jnp.asarray(x) @ p["router"]).astype(
            jnp.float32), axis=-1)
        want = _jax_keep(jax.lax.top_k(probs, K)[1], E, C)
        _, _, top_idx = blocks.route(tp, cfg, torch.from_numpy(x))
        _, keep = blocks.capacity_slots(top_idx.reshape(-1), E, C)
        assert np.array_equal(keep.numpy(), want)
        if factor < 1:
            assert not want.all()      # the tight capacity drops some


def test_zero_router_picks_the_first_experts():
    """A zero router gives every token equal probabilities over 64
    experts; ``jax.lax.top_k`` then takes experts 0..5, and so does the
    port. Both packages' outputs are the mean of those six experts plus
    the shared ones."""
    kw = dict(num_experts=64, top_k=6)
    p, jcfg, tp, cfg = _moe("deepseek-v2-lite-16b", **kw)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(cfg, (2, 5))
    probs = jax.nn.softmax(jnp.zeros((2, 5, 64)), axis=-1)
    assert np.array_equal(np.asarray(jax.lax.top_k(probs, 6)[1]),
                          np.broadcast_to(np.arange(6), (2, 5, 6)))
    _, top_w, top_idx = blocks.route(tp, cfg, torch.from_numpy(x))
    assert torch.equal(top_idx, torch.arange(6).expand(2, 5, 6))
    jy, _ = jblocks.moe_forward_dense(p, jcfg, jnp.asarray(x))
    ty, _ = blocks.moe_forward_dense(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    # the mean of experts 0..5, each the swiglu FFN of its weights
    xf = torch.from_numpy(x)
    silu = torch.nn.functional.silu
    want = sum((silu(xf @ tp["w_gate"][e]) * (xf @ tp["w_in"][e]))
               @ tp["w_out"][e] for e in range(6)) / 6
    want = blocks._with_shared(tp, cfg, want, xf)
    np.testing.assert_allclose(ty.numpy(), want.numpy(), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_drop_capacity_matches_dense(arch):
    """Port of ``TestCapacityMoE::test_no_drop_capacity_matches_dense``:
    with capacity for every assignment, capacity dispatch equals dense."""
    cfg = get_config(arch).reduced()
    cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
    p = blocks.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_x(cfg, (2, 16)))
    y1, a1 = blocks.moe_forward_dense(p, cfg, x)
    y2, a2 = blocks.moe_forward_capacity(p, cfg, x)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(a1.load_balance_loss),
                               float(a2.load_balance_loss), rtol=1e-4)


def test_tight_capacity_drops_but_finite():
    """Port of ``TestCapacityMoE::test_tight_capacity_drops_but_finite``."""
    cfg = get_config("deepseek-v2-lite-16b").reduced().replace(
        capacity_factor=0.5)
    p = blocks.init_moe(torch.Generator().manual_seed(2), cfg)
    y, _ = blocks.moe_forward_capacity(p, cfg,
                                       torch.from_numpy(_x(cfg, (2, 32), 3)))
    assert bool(torch.isfinite(y).all())


def test_capacity_grad_finite():
    """Port of ``TestCapacityMoE::test_capacity_grad_finite``: the
    next-token loss of a capacity-dispatch llama4-scout plus 0.01 x its
    load-balance loss, as ``repro``'s ``DecoderOnlyLM.loss``, has finite
    gradients in every parameter."""
    cfg = get_config("llama4-scout-17b-a16e").reduced().replace(
        moe_dispatch="capacity")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    leaves = list(tree_tensors(params))
    for t in leaves:
        t.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 17)))
    logits, aux = model.forward(params, toks[:, :-1])
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), toks[:, 1:].reshape(-1)) \
        + 0.01 * aux
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert torch.isfinite(loss)
    assert all(g is None or bool(torch.isfinite(g).all()) for g in grads)
    assert sum(g is not None for g in grads) == len(leaves)


def test_split_bf16_sums_to_its_input():
    """The three bf16 parts that the card's expert products take of an
    fp32 operand sum to it exactly, over magnitudes from 1e-30 to 1e30;
    off the card ``_mm_f32`` is the widened product."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((64, 300))
         * 10.0 ** rng.integers(-30, 30, (64, 300))).astype(np.float32)
    hi, mid, lo = blocks._split_bf16(torch.from_numpy(a))
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.float() + mid.float() + lo.float(),
                       torch.from_numpy(a))
    b = torch.from_numpy(rng.standard_normal((300, 7))).to(torch.bfloat16)
    assert torch.equal(blocks._mm_f32(torch.from_numpy(a), b),
                       torch.from_numpy(a) @ b.float())


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_every_leaf(arch):
    """``from_jax_params`` carries every leaf of the JAX tree bit for bit:
    deepseek's ``prefix`` list and both trees' stacked (L, E, d, f) expert
    leaves, layer by layer, in bf16."""
    jm = jax_build_model(jax_get_config(arch).reduced().replace(
        dtype="bfloat16", param_dtype="bfloat16"))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tp = from_jax_params(params, device="cpu")
    assert len(tp["prefix"]) == len(params["prefix"])
    assert len(tp["layers"]) == jm.n_scanned

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tree

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    n = 0
    for path, a in leaves(params):
        if path[0] == "layers":
            for i in range(a.shape[0]):
                got = at(tp["layers"][i], path[1:])
                assert torch.equal(got, to_tensor(a[i], "cpu")), path
                n += 1
        else:
            assert torch.equal(at(tp, path), to_tensor(a, "cpu")), path
            n += 1
    assert n == len(list(tree_tensors(tp)))
    assert tp["layers"][0]["moe"]["w_gate"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _models(arch, **kw):
    jcfg = jax_get_config(arch).reduced().replace(**kw)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced().replace(**kw)
    return (jm, params, build_model(cfg),
            from_jax_params(jax.tree.map(np.asarray, params), device="cpu"),
            cfg)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_moe_model_forward_matches_jax(arch, use_pallas):
    jm, params, tm, tparams, cfg = _models(arch, use_pallas=use_pallas)
    toks = _tokens(cfg, (2, 32))
    jl, jaux = jm.forward(params, jnp.asarray(toks))
    tl, aux = tm.forward(tparams, torch.from_numpy(toks))
    assert tl.shape == (2, 32, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=5e-4)
    assert float(aux) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_prefill_decode_matches_forward(arch):
    _, _, tm, tparams, cfg = _models(arch)
    B, S, CAP = 2, 12, 32
    toks = torch.from_numpy(_tokens(cfg, (B, S + 1)))
    full, _ = tm.forward(tparams, toks)
    pl, cache = tm.prefill(tparams, toks[:, :S], max_len=CAP)
    np.testing.assert_allclose(pl[:, 0].numpy(), full[:, S - 1].numpy(),
                               rtol=2e-4, atol=2e-4)
    assert len(cache["prefix"]) == tm.n_prefix
    pos = torch.full((B,), S, dtype=torch.long)
    dl, new_cache = tm.decode_step(tparams, toks[:, S:S + 1], cache, pos)
    np.testing.assert_allclose(dl[:, 0].numpy(), full[:, S].numpy(),
                               rtol=1e-3, atol=1e-3)
    assert new_cache is cache          # the cache is updated in place


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_ragged_decode_steps_match_jax(arch):
    """Four decode steps from an empty cache at ragged positions: logits,
    and every cache tensor (deepseek's prefix layer's included) against
    JAX's."""
    jm, params, tm, tparams, cfg = _models(arch)
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
    jleaves = jax.tree.leaves(jcache)
    tleaves = list(tree_tensors(tcache))
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   rtol=1e-4, atol=1e-4)
