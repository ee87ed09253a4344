"""The port's Mamba-2 path against the JAX package's, on the CPU: the SSD
scan's plain version, the chunked SSD, the reduced ``MambaLM`` on the JAX
init's weights (converted by ``repro_torch.models.convert``), and the
serving engine through ``TorchBackend``.

Inputs come from numpy with a seed and go through both frameworks.
Tolerances are the reference tests': the SSD scan 2e-4
(``tests/test_kernels.py::test_ssd_sweep``), logits 5e-4 with
``use_pallas`` off and on, prefill vs forward 2e-4 and decode vs forward
1e-3 (``tests/test_models_smoke.py``), decode steps against JAX's 1e-3
(a block's step 1e-4, the states' tolerance). The decode step's plain
version (``kernels.ref.ssd_step``) gives the model's inline step's bits.
The hand-written SSD kernels are held against their plain versions on the
card by ``tests/test_torch_cuda.py``.
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
from repro_torch.models import blocks, build_model
from repro_torch.models.common import rms_norm
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import EngineConfig, InferenceEngine, TorchBackend
from repro_torch.workloads import PROTOTYPES, generate_requests

ARCH = "mamba2-1.3b"
SSD_TOL = dict(rtol=2e-4, atol=2e-4)

# (b, s, h, p, g, n, chunk): the sweep of tests/test_kernels.py, a
# one-token prefill, and an s that the chunk does not divide
SSD_SHAPES = [
    (1, 128, 4, 64, 1, 64, 32),
    (2, 256, 8, 32, 2, 32, 64),
    (1, 64, 2, 64, 1, 128, 16),
    (1, 1, 4, 64, 1, 64, 128),
    (2, 40, 4, 32, 2, 32, 16),
]


def _ssd_inputs(seed, b, s, h, p, g, n):
    """The distributions of ``test_ssd_sweep``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f)
    A = np.exp(0.3 * rng.standard_normal((h,))).astype(f)
    B = (0.5 * rng.standard_normal((b, s, g, n))).astype(f)
    C = (0.5 * rng.standard_normal((b, s, g, n))).astype(f)
    return x, dt, A, B, C


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# the SSD scan and the chunked SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_ssd_scan_plain_matches_jax(b, s, h, p, g, n, chunk):
    """The port's ``ops.ssd_scan`` (its plain version on the CPU) against
    the token-by-token oracle and the Pallas kernel in interpret mode."""
    args = _ssd_inputs(6, b, s, h, p, g, n)
    y, st = ops.ssd_scan(*(torch.from_numpy(a) for a in args), chunk=chunk)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    jargs = [jnp.asarray(a) for a in args]
    for fn in (jref.ssd_scan, jops.ssd_scan):
        y_j, st_j = fn(*jargs, chunk=chunk)
        _close(y.numpy(), y_j, **SSD_TOL)
        _close(st.numpy(), st_j, **SSD_TOL)


@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 16), (7, 4), (1, 16)])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_ssd_chunked_matches_jax(s, chunk, use_pallas):
    """``blocks.ssd_chunked`` on both paths, with the dt=0 padding where
    the chunk does not divide s (plain) and the chunk halving (kernel)."""
    args = _ssd_inputs(7, 2, s, 4, 32, 2, 32)
    y, st = blocks.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk,
                               use_pallas=use_pallas)
    y_j, st_j = jblocks.ssd_chunked(*(jnp.asarray(a) for a in args), chunk,
                                    use_pallas=use_pallas)
    _close(y.numpy(), y_j, **SSD_TOL)
    _close(st.numpy(), st_j, **SSD_TOL)


@pytest.mark.parametrize("s,want", [(1, 1), (2, 2), (40, 8), (64, 64),
                                    (128, 128), (256, 128), (96, 32)])
def test_ssd_chunk_rule(monkeypatch, s, want):
    """Halve the chunk until it divides s, as ``repro.kernels.ops`` does."""
    seen = []

    def spy(x, dt, A, B, C, *, chunk):
        seen.append(chunk)
        return x, None

    monkeypatch.setattr(ops, "_ssd", spy)
    ops.ssd_scan(*(torch.zeros(sh) for sh in
                   ((1, s, 2, 4), (1, s, 2), (2,), (1, s, 1, 4),
                    (1, s, 1, 4))), chunk=128)
    assert seen == [want]


# ---------------------------------------------------------------------------
# the model on the JAX init's weights
# ---------------------------------------------------------------------------

def _models(**kw):
    jcfg = jax_get_config(ARCH).reduced().replace(**kw)
    tcfg = get_config(ARCH).reduced().replace(**kw)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, params),
                              device="cpu")
    return jm, params, build_model(tcfg), tparams, tcfg


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("S", [32, 40])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_jax(S, use_pallas):
    jm, params, tm, tparams, cfg = _models(use_pallas=use_pallas)
    toks = _tokens(cfg, (2, S))
    jl, _ = jm.forward(params, jnp.asarray(toks))
    tl, aux = tm.forward(tparams, torch.from_numpy(toks))
    assert tl.shape == (2, S, cfg.vocab_size) and float(aux) == 0.0
    _close(tl.numpy(), jl, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_decode_matches_forward(use_pallas):
    _, _, tm, tparams, cfg = _models(use_pallas=use_pallas)
    B, S, CAP = 2, 12, 32
    toks = torch.from_numpy(_tokens(cfg, (B, S + 1)))
    full, _ = tm.forward(tparams, toks)
    pl, cache = tm.prefill(tparams, toks[:, :S], max_len=CAP)
    _close(pl[:, 0].numpy(), full[:, S - 1].numpy(), rtol=2e-4, atol=2e-4)
    L, H, P, N = (cfg.num_layers, cfg.ssm_nheads, cfg.ssm_head_dim,
                  cfg.ssm_state)
    assert cache.ssm.shape == (L, B, H, P, N)
    assert cache.conv.shape == (L, B, cfg.conv_kernel - 1,
                                cfg.d_inner + 2 * cfg.ssm_ngroups * N)
    pos = torch.full((B,), S, dtype=torch.long)
    dl, new_cache = tm.decode_step(tparams, toks[:, S:S + 1], cache, pos)
    _close(dl[:, 0].numpy(), full[:, S].numpy(), rtol=1e-3, atol=1e-3)
    assert new_cache.ssm.shape == cache.ssm.shape


def _unfused_run(tm, params, toks, cache=None):
    """The Mamba-2 stack with each layer summing its own output before a
    plain norm: forward logits, or one decode step's (logits, cache)."""
    cfg = tm.cfg
    x = tm._embed(params, toks)
    states = []
    for i, lp in enumerate(params["layers"]):
        r = rms_norm(x, lp["norm"], cfg.norm_eps)
        state = None if cache is None else blocks.SSDState(
            ssm=cache.ssm[i], conv=cache.conv[i])
        y, st = blocks.ssd_block_forward(lp["mixer"], cfg, r, state=state)
        x = x + y
        states.append(st)
    logits = tm._unembed(params, x, None)
    if cache is None:
        return logits
    return logits, blocks.SSDState(ssm=torch.stack([s.ssm for s in states]),
                                   conv=torch.stack([s.conv for s in states]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_residual_norms_match_explicit_adds(dtype):
    """Handing each layer's residual add to the next norm (and the final
    norm) changes no bit on the plain path: forward logits, and a decode
    step's logits and states, equal those of layers that sum their own
    outputs."""
    _, _, _, tparams, cfg = _models()
    tm = build_model(cfg.replace(dtype=dtype))
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, (B, S + 1)))
    fwd, _ = tm.forward(tparams, toks)
    assert torch.equal(fwd, _unfused_run(tm, tparams, toks))
    _, cache = tm.prefill(tparams, toks[:, :S])
    # decode_step writes its cache in place: the reference steps a copy
    ref_cache = blocks.SSDState(*(t.clone() for t in cache))
    pos = torch.full((B,), S, dtype=torch.long)
    dl, new = tm.decode_step(tparams, toks[:, S:], cache, pos)
    dl_ref, new_ref = _unfused_run(tm, tparams, toks[:, S:],
                                   cache=ref_cache)
    assert torch.equal(dl, dl_ref)
    assert torch.equal(new.ssm, new_ref.ssm)
    assert torch.equal(new.conv, new_ref.conv)


def test_decode_steps_match_jax():
    """Four decode steps from a zero state, logits and states."""
    jm, params, tm, tparams, cfg = _models()
    B = 3
    jcache = jm.init_cache(B, 16)
    tcache = tm.init_cache(B, 16, device="cpu")
    pos = np.array([0, 5, 11])
    toks = _tokens(cfg, (4, B, 1), seed=2)
    for i in range(4):
        jl, jcache = jm.decode_step(params, jnp.asarray(toks[i]), jcache,
                                    jnp.asarray(pos + i, jnp.int32))
        tl, tcache = tm.decode_step(tparams, torch.from_numpy(toks[i]),
                                    tcache, torch.from_numpy(pos + i))
        _close(tl.numpy(), jl, rtol=1e-3, atol=1e-3)
    _close(tcache.ssm.numpy(), jcache.ssm, rtol=1e-4, atol=1e-4)
    _close(tcache.conv.numpy(), jcache.conv, rtol=1e-4, atol=1e-4)


def _branch_step(x, dt, A, B, C, D, ssm):
    """The model's decode step as ``blocks._ssd_heads`` computed it inline
    before it called ``kernels.ssd_step``: the plain version's yardstick."""
    H, G = x.shape[1], B.shape[1]
    dA = torch.exp(-dt[:, :, None, None] * A[None, :, None, None])
    Bs = torch.repeat_interleave(B, H // G, dim=1)
    Cs = torch.repeat_interleave(C, H // G, dim=1)
    upd = dt[:, :, None, None] * torch.einsum("bhn,bhp->bhpn", Bs, x)
    final = ssm.mul_(dA).add_(upd)
    y = torch.einsum("bhn,bhpn->bhp", Cs, final)
    return y + D[None, :, None] * x


def _step_inputs(seed, b, h, p, g, n):
    """A decode step's operands as the block gives them: x, B and C through
    silu, dt through softplus, A = exp(A_log) at mamba2's init rates, and a
    state from earlier steps."""
    rng = np.random.default_rng(seed)
    f = np.float32
    def silu(a):
        return (a / (1.0 + np.exp(-a))).astype(f)

    x = silu(rng.standard_normal((b, h, p)))
    dt = np.log1p(np.exp(rng.standard_normal((b, h)) - 2.0)).astype(f)
    A = np.linspace(1.0, 16.0, h).astype(f)
    B, C = (silu(rng.standard_normal((b, g, n))) for _ in range(2))
    D = (1.0 + 0.1 * rng.standard_normal(h)).astype(f)
    state = rng.standard_normal((b, h, p, n)).astype(f)
    return x, dt, A, B, C, D, state


@pytest.mark.parametrize("b,h,p,g,n", [(3, 4, 16, 1, 32), (2, 6, 8, 2, 16),
                                       (2, 64, 64, 1, 128)])
def test_ssd_step_plain_is_the_branch(b, h, p, g, n):
    """``ref.ssd_step`` gives the branch's bits, y and state, at the sweep's
    widths, two groups and mamba2-1.3b's heads; it writes the state it is
    given and returns the step's output."""
    ins = [torch.from_numpy(a) for a in _step_inputs(0, b, h, p, g, n)]
    state, want_state = ins[-1], ins[-1].clone()
    ptr = state.data_ptr()
    y = ops.ssd_step(*ins)
    want = _branch_step(*ins[:-1], want_state)
    assert y.shape == (b, h, p) and state.data_ptr() == ptr
    assert torch.equal(y, want)
    assert torch.equal(state, want_state)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_decode_block_matches_jax(use_pallas):
    """A Mamba-2 block's decode step from a random state and conv tail, on
    the JAX init's weights: its output and new state against the JAX
    package's at the model's tolerance (1e-4, the states' in
    ``test_decode_steps_match_jax``), the new state written into the state
    given, and on the CPU no kernel launch with ``use_pallas`` either."""
    jm, params, _, tparams, cfg = _models(use_pallas=use_pallas)
    jlp = jax.tree.map(lambda a: a[0], params["layers"])["mixer"]
    tlp = tparams["layers"][0]["mixer"]
    rng = np.random.default_rng(3)
    B, H, P, N = 3, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * N
    u = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ssm = (0.5 * rng.standard_normal((B, H, P, N))).astype(np.float32)
    tail = rng.standard_normal((B, cfg.conv_kernel - 1,
                                conv_dim)).astype(np.float32)
    jout, jstate = jblocks.ssd_block_forward(
        jlp, jm.cfg, jnp.asarray(u),
        jblocks.SSDState(ssm=jnp.asarray(ssm), conv=jnp.asarray(tail)))
    state = blocks.SSDState(ssm=torch.from_numpy(ssm.copy()),
                            conv=torch.from_numpy(tail.copy()))
    ptr = state.ssm.data_ptr()
    reset_launch_counts()
    out, new = blocks.ssd_block_forward(tlp, cfg, torch.from_numpy(u),
                                        state=state)
    assert launch_counts()["ssd_step"] == 0
    assert new.ssm.data_ptr() == ptr
    _close(out.numpy(), jout, rtol=1e-4, atol=1e-4)
    _close(new.ssm.numpy(), jstate.ssm, rtol=1e-4, atol=1e-4)
    _close(new.conv.numpy(), jstate.conv, rtol=1e-4, atol=1e-4)


def test_only_a_step_under_use_pallas_takes_the_kernel(monkeypatch):
    """With ``use_pallas`` a decode step goes through ``kernels.ssd_step``,
    without it the plain step; both give the plain path's bits here, on
    the CPU."""
    cfg = get_config(ARCH).reduced()
    H, P, N = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    calls = []
    real = ops.ssd_step

    def seen(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(ops, "ssd_step", seen)
    rng = np.random.default_rng(4)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    z, x = t(2, 1, H * P), t(2, 1, H * P)
    Bm, Cm, dt = t(2, 1, N), t(2, 1, N), t(2, 1, H)
    small = (0.1 * t(H), 0.5 * t(H), 1.0 + 0.1 * t(H))
    ssm = t(2, H, P, N)
    outs = []
    for use_pallas in (True, False):
        state = ssm.clone()
        outs.append(blocks._ssd_heads(cfg.replace(use_pallas=use_pallas), z,
                                      x, Bm, Cm, dt, *small, state) + (state,))
    assert calls == [(2, H, P)]
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def test_init_and_conversion_match_the_jax_tree():
    """The port's own init has the JAX init's tree, shapes and dtypes, also
    in bf16, where ``A_log``, ``D`` and ``dt_bias`` stay fp32; tied
    embeddings mean no ``lm_head``."""
    for kw in ({}, dict(dtype="bfloat16", param_dtype="bfloat16")):
        jcfg = jax_get_config(ARCH).reduced().replace(**kw)
        cfg = get_config(ARCH).reduced().replace(**kw)
        conv = from_jax_params(jax.tree.map(
            np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0))),
            device="cpu")
        own = build_model(cfg).init(torch.Generator().manual_seed(0))
        assert "lm_head" not in own and "lm_head" not in conv
        assert len(own["layers"]) == len(conv["layers"]) == cfg.num_layers
        flat_own = _flat(own)
        flat_conv = _flat(conv)
        assert flat_own.keys() == flat_conv.keys()
        for k, t in flat_own.items():
            assert t.shape == flat_conv[k].shape, k
            assert t.dtype == flat_conv[k].dtype, k
        mixer = conv["layers"][0]["mixer"]
        for name in ("A_log", "D", "dt_bias"):
            assert mixer[name].dtype == torch.float32
        assert mixer["w_in"].dtype == cfg.weight_dtype


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
    """The copy of ``test_torch_engine`` for Mamba-2: ``TorchBackend`` on
    the CPU with AGFT attached drains 6 requests; each decode step writes
    the new state into the backend's own cache."""
    cfg = get_config(ARCH).reduced()
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
    state0 = backend.cache
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
    assert backend.cache is state0
    assert float(backend.cache.ssm.abs().max()) > 0.0
    assert all(n == 0 for n in launch_counts().values())
