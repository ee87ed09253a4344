"""The port's RecurrentGemma path against the JAX package's, on the CPU: the
RG-LRU scan's plain version, the decode attention's plain version at
RecurrentGemma's head shape (16 query heads over one kv head, head_dim
256), the reduced ``HybridLM`` on the JAX init's weights (converted by
``repro_torch.models.convert``), and the serving engine through
``TorchBackend``.

The hybrid is checked at ``num_layers=3`` (what ``reduced()`` gives: one
(rec, rec, attn) unit, no tail) and at ``num_layers=5`` (one unit and a
tail of two rec layers, the shape of the full model's 12 units + 2).

Inputs come from numpy with a seed and go through both frameworks.
Tolerances are the reference tests': the RG-LRU scan 1e-5
(``tests/test_kernels.py::test_rglru_sweep``), decode attention 2e-5 in
fp32 and 2e-2 in bf16, logits 5e-4 with ``use_pallas`` off and on,
prefill vs forward 2e-4 and decode vs forward 1e-3
(``tests/test_models_smoke.py``), decode steps against JAX's 1e-3. The
hand-written kernels are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import blocks as jblocks
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core import AGFTConfig, AGFTTuner
from repro_torch.energy import A6000
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.models import attention as attn
from repro_torch.models import blocks, build_model
from repro_torch.models.common import model_rope
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import EngineConfig, InferenceEngine, TorchBackend
from repro_torch.workloads import PROTOTYPES, generate_requests

ARCH = "recurrentgemma-9b"
LRU_TOL = dict(rtol=1e-5, atol=1e-5)
DEC_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}
LAYERS = [3, 5]

# (B, S, W): the sweep of tests/test_kernels.py, and S = 2, the shortest
# prefill that runs the scan
RGLRU_SHAPES = [(1, 64, 128), (2, 256, 256), (3, 128, 384), (2, 2, 128)]


def _rglru_inputs(seed, B, S, W):
    """The distributions of ``test_rglru_sweep``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, W)).astype(f)
    log_a = (-np.log1p(np.exp(rng.standard_normal((B, S, W))))).astype(f)
    h0 = rng.standard_normal((B, W)).astype(f)
    return x, log_a, h0


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# the RG-LRU scan and decode attention at D = 256, G = 16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,W", RGLRU_SHAPES)
def test_rglru_scan_plain_matches_jax(B, S, W):
    """The port's ``ops.rglru_scan`` (its plain version on the CPU) against
    the oracle and the Pallas kernel in interpret mode."""
    args = _rglru_inputs(5, B, S, W)
    ys, hl = ops.rglru_scan(*(torch.from_numpy(a) for a in args))
    assert ys.shape == (B, S, W) and hl.shape == (B, W)
    jargs = [jnp.asarray(a) for a in args]
    for fn in (jref.rglru_scan, jops.rglru_scan):
        ys_j, hl_j = fn(*jargs)
        _close(ys.numpy(), ys_j, **LRU_TOL)
        _close(hl.numpy(), hl_j, **LRU_TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_rglru_scan_block_matches_jax(use_pallas):
    """``blocks.rglru_scan`` on both paths against the JAX package's (its
    plain path is an associative scan: another order of float sums)."""
    args = _rglru_inputs(6, 2, 48, 256)
    ys, hl = blocks.rglru_scan(*(torch.from_numpy(a) for a in args),
                               use_pallas=use_pallas)
    ys_j, hl_j = jblocks.rglru_scan(*(jnp.asarray(a) for a in args),
                                    use_pallas=use_pallas)
    _close(ys.numpy(), ys_j, **LRU_TOL)
    _close(hl.numpy(), hl_j, **LRU_TOL)


@pytest.mark.parametrize("S,carried", [(48, False), (1, True)])
@pytest.mark.parametrize("jax_pallas", [False, True])
def test_rglru_gated_block_matches_jax(S, carried, jax_pallas):
    """The recurrent block through the fused form's plain version (what
    the block runs on the CPU, kernels or not) against the JAX package's
    ``rglru_block_forward`` on the same weights: a 48-token prefill from a
    zero state, and a decode step's one token from a carried state (the
    JAX package's inline step); the JAX side through its plain scan or its
    Pallas kernel."""
    cfg = get_config(ARCH).reduced()
    jcfg = jax_get_config(ARCH).reduced().replace(use_pallas=jax_pallas)
    jp = jblocks.init_rglru_block(jax.random.PRNGKey(3), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    B, W = 2, cfg.lru_width
    rng = np.random.default_rng(31)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jstate = tstate = None
    if carried:
        h = rng.standard_normal((B, W)).astype(np.float32)
        conv = rng.standard_normal((B, cfg.conv_kernel - 1, W)).astype(
            np.float32)
        jstate = jblocks.RGLRUState(h=jnp.asarray(h), conv=jnp.asarray(conv))
        tstate = blocks.RGLRUState(h=torch.from_numpy(h),
                                   conv=torch.from_numpy(conv))
    for use_pallas in (False, True):
        # the block writes a given state in place: give each call a copy
        y, st = blocks.rglru_block_forward(
            tp, cfg.replace(use_pallas=use_pallas), torch.from_numpy(x),
            tstate and blocks.RGLRUState(*(t.clone() for t in tstate)))
        jy, jst = jblocks.rglru_block_forward(jp, jcfg, jnp.asarray(x),
                                              jstate)
        assert y.shape == (B, S, cfg.d_model)
        _close(y.numpy(), jy, **LRU_TOL)
        _close(st.h.numpy(), jst.h, **LRU_TOL)
        _close(st.conv.numpy(), jst.conv, **LRU_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_wide_group_matches_jax(dtype):
    """16 query heads over one kv head at head_dim 256, ring-buffer
    validity, and one row with no valid slot (0, as the Pallas kernel
    gives)."""
    B, T, H, Hkv, D = 3, 256, 16, 1, 256
    rng = np.random.default_rng(9)
    q, kc, vc = (rng.standard_normal(s).astype(np.float32) for s in
                 ((B, 1, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    valid = rng.random((B, T)) < 0.7
    valid[-1] = False
    tt = getattr(torch, dtype)
    got = ops.decode_attention(*(torch.from_numpy(a).to(tt)
                                 for a in (q, kc, vc)),
                               torch.from_numpy(valid)).float().numpy()
    jd = jnp.dtype(dtype)
    jargs = (jnp.asarray(q).astype(jd), jnp.asarray(kc).astype(jd),
             jnp.asarray(vc).astype(jd), jnp.asarray(valid))
    pallas = np.asarray(jops.decode_attention(*jargs), np.float32)
    np.testing.assert_array_equal(got[-1], 0.0)
    _close(got, pallas, **DEC_TOL[dtype])
    _close(got[:-1], np.asarray(jref.decode_attention(*jargs),
                                np.float32)[:-1], **DEC_TOL[dtype])


# ---------------------------------------------------------------------------
# the model on the JAX init's weights
# ---------------------------------------------------------------------------

def _models(num_layers, **kw):
    kw = dict(kw, num_layers=num_layers)
    jcfg = jax_get_config(ARCH).reduced().replace(**kw)
    tcfg = get_config(ARCH).reduced().replace(**kw)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, params),
                              device="cpu")
    return jm, params, build_model(tcfg), tparams, tcfg


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("num_layers", LAYERS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_jax(num_layers, use_pallas):
    """S = 40 is past the reduced window of 32, so the band bites."""
    jm, params, tm, tparams, cfg = _models(num_layers,
                                           use_pallas=use_pallas)
    assert tm.n_tail == num_layers - 3
    toks = _tokens(cfg, (2, 40))
    jl, _ = jm.forward(params, jnp.asarray(toks))
    tl, aux = tm.forward(tparams, torch.from_numpy(toks))
    assert tl.shape == (2, 40, cfg.vocab_size) and float(aux) == 0.0
    _close(tl.numpy(), jl, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("num_layers", LAYERS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_decode_matches_forward(num_layers, use_pallas):
    _, _, tm, tparams, cfg = _models(num_layers, use_pallas=use_pallas)
    B, S, CAP = 2, 12, 32
    toks = torch.from_numpy(_tokens(cfg, (B, S + 1)))
    full, _ = tm.forward(tparams, toks)
    pl, cache = tm.prefill(tparams, toks[:, :S], max_len=CAP)
    _close(pl[:, 0].numpy(), full[:, S - 1].numpy(), rtol=2e-4, atol=2e-4)
    kv = cache["units"][0]["l2"]
    assert kv.k.shape == (B, cfg.local_window, cfg.num_kv_heads,
                          cfg.head_dim)
    assert len(cache["tail"]) == num_layers - 3
    pos = torch.full((B,), S, dtype=torch.long)
    dl, _ = tm.decode_step(tparams, toks[:, S:S + 1], cache, pos)
    _close(dl[:, 0].numpy(), full[:, S].numpy(), rtol=1e-3, atol=1e-3)


def _unfused_run(tm, params, toks, cache=None, pos=None):
    """The hybrid stack with each layer summing its own output, x +
    pending, and each norm taking a summed x (the layers called with no
    pending add): forward logits, or one decode step's (logits, cache), or
    with neither the prefill's."""
    B, S = toks.shape
    cfg = tm.cfg
    if cache is None:
        rope = model_rope(cfg, torch.arange(S)[None].expand(B, S))
    else:
        slots = attn.decode_slots(cfg, cfg.local_window, pos,
                                  window=cfg.local_window)
        rope = model_rope(cfg, pos[:, None])
    x = tm._embed(params, toks)
    layers = [(up[f"l{i}"], kind, f"l{i}", u)
              for u, up in enumerate(params["units"])
              for i, kind in enumerate(tm.pattern)]
    layers += [(lp, "rec", None, t) for t, lp in enumerate(params["tail"])]
    new = {"units": [{} for _ in params["units"]], "tail": []}
    for lp, kind, key, idx in layers:
        if cache is None:
            x, pending, c = tm._layer_full(lp, kind, x, None, rope)
        else:
            old = cache["units"][idx][key] if key else cache["tail"][idx]
            x, pending, c = tm._layer_decode(lp, kind, x, None, old, slots,
                                             rope)
        if key:
            new["units"][idx][key] = c
        else:
            new["tail"].append(c)
        x = x + pending
    return tm._unembed(params, x, None), new


def _tree_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_tree_equal, a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("num_layers", LAYERS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_residual_norms_match_explicit_adds(num_layers, dtype):
    """Handing each layer's last residual add to the next norm (and the
    final norm) changes no bit on the plain path: forward logits, and a
    decode step's logits and caches, equal those of layers that sum their
    own outputs."""
    _, _, _, tparams, cfg = _models(num_layers)
    tm = build_model(cfg.replace(dtype=dtype))
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, (B, S + 1)))
    fwd, _ = tm.forward(tparams, toks)
    assert torch.equal(fwd, _unfused_run(tm, tparams, toks)[0])
    _, cache = tm.prefill(tparams, toks[:, :S])
    _, ref_cache = _unfused_run(tm, tparams, toks[:, :S])
    assert _tree_equal(cache, ref_cache)
    pos = torch.full((B,), S, dtype=torch.long)
    dl, new = tm.decode_step(tparams, toks[:, S:], cache, pos)
    dl_ref, new_ref = _unfused_run(tm, tparams, toks[:, S:],
                                   cache=ref_cache, pos=pos)
    assert torch.equal(dl, dl_ref)
    assert _tree_equal(new, new_ref)


@pytest.mark.parametrize("num_layers", LAYERS)
def test_decode_steps_match_jax(num_layers):
    """Four decode steps from a zero cache; the row at position 30 wraps
    the 32-slot ring."""
    jm, params, tm, tparams, cfg = _models(num_layers)
    B = 3
    jcache = jm.init_cache(B, 16)
    tcache = tm.init_cache(B, 16, device="cpu")
    pos = np.array([0, 5, 30])
    toks = _tokens(cfg, (4, B, 1), seed=2)
    for i in range(4):
        jl, jcache = jm.decode_step(params, jnp.asarray(toks[i]), jcache,
                                    jnp.asarray(pos + i, jnp.int32))
        tl, tcache = tm.decode_step(tparams, torch.from_numpy(toks[i]),
                                    tcache, torch.from_numpy(pos + i))
        _close(tl.numpy(), jl, rtol=1e-3, atol=1e-3)
    _close(tcache["units"][0]["l0"].h.numpy(), jcache["units"]["l0"].h[0],
           rtol=1e-4, atol=1e-4)
    _close(tcache["units"][0]["l2"].k.numpy(), jcache["units"]["l2"].k[0],
           rtol=1e-4, atol=1e-4)
    for t, j in zip(tcache["tail"], jcache["tail"]):
        _close(t.h.numpy(), j.h, rtol=1e-4, atol=1e-4)
        _close(t.conv.numpy(), j.conv, rtol=1e-4, atol=1e-4)


def test_prefill_past_the_window_then_decode_matches_jax():
    """Prefill longer than the window (the ring roll), then decode steps."""
    jm, params, tm, tparams, cfg = _models(5)
    B, S = 2, 37
    toks = _tokens(cfg, (B, S + 3))
    jl, jcache = jm.prefill(params, jnp.asarray(toks[:, :S]))
    tl, tcache = tm.prefill(tparams, torch.from_numpy(toks[:, :S]))
    _close(tl.numpy(), jl, rtol=5e-4, atol=5e-4)
    _close(tcache["units"][0]["l2"].k.numpy(), jcache["units"]["l2"].k[0],
           rtol=1e-4, atol=1e-4)
    for i in range(3):
        pos = np.full((B,), S + i)
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = jm.decode_step(params, jnp.asarray(tok), jcache,
                                    jnp.asarray(pos, jnp.int32))
        tl, tcache = tm.decode_step(tparams, torch.from_numpy(tok), tcache,
                                    torch.from_numpy(pos))
        _close(tl.numpy(), jl, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("num_layers", LAYERS)
def test_init_and_conversion_match_the_jax_tree(num_layers):
    """The port's own init has the JAX init's tree (``units`` of l0/l1/l2
    layer dicts, a ``tail`` list of rec layers), shapes and dtypes, also in
    bf16, where ``lambda_param`` stays fp32."""
    for kw in ({}, dict(dtype="bfloat16", param_dtype="bfloat16")):
        kw = dict(kw, num_layers=num_layers)
        jcfg = jax_get_config(ARCH).reduced().replace(**kw)
        cfg = get_config(ARCH).reduced().replace(**kw)
        conv = from_jax_params(jax.tree.map(
            np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0))),
            device="cpu")
        own = build_model(cfg).init(torch.Generator().manual_seed(0))
        assert len(conv["units"]) == 1 and len(conv["tail"]) == \
            num_layers - 3
        flat_own, flat_conv = _flat(own), _flat(conv)
        assert flat_own.keys() == flat_conv.keys()
        for k, t in flat_own.items():
            assert t.shape == flat_conv[k].shape, k
            assert t.dtype == flat_conv[k].dtype, k
        rec = conv["units"][0]["l0"]["mixer"]
        assert rec["lambda_param"].dtype == torch.float32
        assert rec["w_x"].dtype == cfg.weight_dtype


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_engine_with_real_torch_execution():
    """The copy of ``test_torch_engine`` for RecurrentGemma (with its tail
    of two rec layers): ``TorchBackend`` on the CPU with AGFT attached
    drains 6 requests; each decode step writes the new states into the
    backend's own cache."""
    cfg = get_config(ARCH).reduced().replace(num_layers=5)
    backend = TorchBackend(cfg, A6000, max_batch=4, cache_len=64,
                           device="cpu")
    eng = InferenceEngine(cfg, EngineConfig(max_num_seqs=4,
                                            max_batched_tokens=256,
                                            prefill_chunk=64),
                          hardware=A6000, backend=backend,
                          initial_frequency=A6000.f_max)
    reqs = generate_requests(PROTOTYPES["normal"], 6, base_rate=50.0, seed=0)
    for r in reqs:
        r.prompt_len = min(r.prompt_len, 48)
        r.output_len = min(r.output_len, 8)
    eng.submit(reqs)
    tuner = AGFTTuner(A6000, AGFTConfig(sampling_period_s=0.2))
    tail0 = backend.cache["tail"][0]
    reset_launch_counts()
    eng.drain(policy=tuner, max_iters=2000)
    assert len(eng.finished) == 6
    assert eng.metrics.c.energy_joules_total > 0
    assert all(r.generated == r.output_len for r in eng.finished)
    assert eng.frequency >= A6000.f_min
    assert backend.prefill_steps > 0 and backend.decode_steps > 0
    # each forward ran at a power-of-two bucket of at most 64 tokens
    assert all(n & (n - 1) == 0 and n <= 64
               for n in backend.prefill_lengths)
    assert backend.cache["tail"][0] is tail0
    assert float(backend.cache["tail"][0].h.abs().max()) > 0.0
    assert all(n == 0 for n in launch_counts().values())
