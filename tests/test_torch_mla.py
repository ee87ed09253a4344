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
hold theirs. MLA's decode in the latent space (the weights absorbed)
against JAX's up-projected decode at fp32's 2e-5, and placed against plain
at the placed tests' 2e-5 (``tests/test_torch_dryrun.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

import repro_torch.models.attention as attention_mod
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models.common import apply_rope as jax_apply_rope
from repro_torch.configs import get_config
from repro_torch.distributed import (PSpec, cache_pspecs, param_pspecs,
                                     with_sharding)
from repro_torch.kernels import mla_decode as mla_kernel
from repro_torch.kernels import ref
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model, tree_tensors
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


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("kv_update", ["onehot", "scatter"])
def test_absorbed_mla_decode_matches_jax(kv_update, use_pallas):
    """``mla_decode`` in the latent space (``w_uk`` and ``w_uv`` absorbed;
    through the kernel's wrapper, which runs its plain version on the CPU,
    or through the plain version) against JAX's decode, which up-projects
    every cached latent, at fp32's 2e-5: four steps at ragged positions
    from a random cache, a row whose only valid slot is its own new entry
    (position 0), one at the last slot and one past it (JAX clamps it to
    the last slot, which it overwrites)."""
    p, jcfg, tp, cfg = _mla()
    jcfg = jcfg.replace(kv_update=kv_update)
    cfg = cfg.replace(kv_update=kv_update, use_pallas=use_pallas)
    B, T = 4, 16
    c_kv, k_rope, xs = _normal(8, (B, T, cfg.kv_lora_rank),
                               (B, T, cfg.qk_rope_head_dim),
                               (4, B, 1, cfg.d_model))
    jc = jattn.MLACache(jnp.asarray(c_kv), jnp.asarray(k_rope))
    tc = attention_mod.MLACache(*_t(c_kv.copy(), k_rope.copy()))
    pos = np.array([0, 6, 12, 15])
    for i in range(4):
        step = pos + i
        jy, jc = jattn.mla_decode(p, jcfg, jnp.asarray(xs[i]), jc,
                                  jnp.asarray(step, jnp.int32))
        tpos = torch.from_numpy(step)
        slots = attention_mod.decode_slots(cfg, T, tpos)
        before = mla_kernel.mla_decode.launches
        ty, out = attention_mod.mla_decode(tp, cfg, torch.from_numpy(xs[i]),
                                           tc, slots,
                                           model_rope(cfg, tpos[:, None]))
        # a CPU call runs the plain version: nothing launches
        assert mla_kernel.mla_decode.launches == before
        assert all(a is b for a, b in zip(out, tc))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5,
                                   atol=2e-5)
    for t, j in zip(tc, jc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


def test_mla_decode_plain_is_the_up_projected_sum():
    """The kernel's plain version, on queries taken into the latent space,
    equals attention over up-projected keys and values (the port's
    ``_mla_scores``) at 2e-5, a row of a single valid slot included; a row
    with no valid slot gives 0, as the decode kernels do."""
    H, nope, rp, R, vd, B, T = 3, 8, 4, 12, 6, 3, 10
    q_nope, q_rope, c_kv, k_rope, w_uk, w_uv = _t(*_normal(
        9, (B, 1, H, nope), (B, 1, H, rp), (B, T, R), (B, T, rp),
        (R, H, nope), (R, H, vd)))
    valid = torch.arange(T)[None] < torch.tensor([1, 7, T])[:, None]
    scale = (nope + rp) ** -0.5
    q = torch.cat([torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk),
                   q_rope[:, 0]], dim=-1)
    got = torch.einsum("bhr,rhv->bhv",
                       ref.mla_decode(q, c_kv, k_rope, valid, scale), w_uv)
    k_up = torch.einsum("btr,rhn->bthn", c_kv, w_uk)
    v_up = torch.einsum("btr,rhv->bthv", c_kv, w_uv)
    want = attention_mod._mla_scores(q_nope, q_rope, k_up, v_up, k_rope,
                                     valid[:, None, None], scale)[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    none = torch.zeros_like(valid)
    assert float(ref.mla_decode(q, c_kv, k_rope, none, scale).abs().max()) \
        == 0.0


def _mla_operands(dtype=torch.float32, B=2, H=4, T=32, R=64, RP=16):
    g = torch.Generator().manual_seed(0)
    q, c_kv, k_rope = (torch.randn(s, generator=g).to(dtype)
                       for s in ((B, H, R + RP), (B, T, R), (B, T, RP)))
    valid = torch.arange(T)[None] < (torch.arange(B) * 7 % T + 1)[:, None]
    return q, c_kv, k_rope, valid


def _bad_operands():
    """(error, operands, what checks them): the function's own checks run
    on every device (the wrapper), the kernel's limits on the card
    (``_check_kernel``, called here directly)."""
    q, c_kv, k_rope, valid = _mla_operands()
    bf = _mla_operands(torch.bfloat16)
    return {
        "int valid": (TypeError, (q, c_kv, k_rope, valid.int()), "call"),
        "mixed dtypes": (TypeError, (q, c_kv.bfloat16(), k_rope, valid),
                         "call"),
        "fp16": (TypeError, tuple(t.half() if t.is_floating_point() else t
                                  for t in (q, c_kv, k_rope, valid)),
                 "call"),
        "k_rope's width": (ValueError, (q, c_kv, k_rope[..., :8], valid),
                           "call"),
        "valid's slots": (ValueError, (q, c_kv, k_rope, valid[:, :-1]),
                          "call"),
        "a strided latent": (ValueError,
                             (q, torch.randn(2, 32, 128)[..., ::2], k_rope,
                              valid), "call"),
        "more than 16 heads": (ValueError, _mla_operands(H=17), "kernel"),
        "more than 1024 rows": (ValueError, _mla_operands(B=1025),
                                "kernel"),
        # views of one row (no memory)
        "more tiles than the merge holds": (ValueError, (
            q[:1].expand(129, 4, 80), c_kv[:1, :1].expand(129, 32768, 64),
            k_rope[:1, :1].expand(129, 32768, 16),
            valid[:1, :1].expand(129, 32768)), "kernel"),
        "bf16 widths of no build": (ValueError,
                                    _mla_operands(torch.bfloat16, R=32),
                                    "kernel"),
        "a misaligned bf16 row": (ValueError,
                                  (bf[0], torch.randn(2, 32, 65).bfloat16()
                                   [..., 1:], bf[2], bf[3]), "kernel"),
    }


@pytest.mark.parametrize("case", list(_bad_operands()))
def test_mla_decode_wrapper_refuses_bad_operands(case):
    """The wrapper's checks of shapes, dtypes and strides, on every device
    (the CPU too, where it then runs the plain version), and of the
    kernel's limits (sizes, the bf16 widths it is built for, 16-byte bf16
    rows), which it applies before a launch: each raises, and nothing
    launches."""
    error, args, where = _bad_operands()[case]
    before = mla_kernel.mla_decode.launches
    with pytest.raises(error, match="^mla_decode"):
        if where == "call":
            mla_kernel.mla_decode(*args, 0.1)
        else:
            mla_kernel._check(*args)
            mla_kernel._check_kernel(*args[:3])
    assert mla_kernel.mla_decode.launches == before
    # good operands pass both and run
    q, c_kv, k_rope, valid = _mla_operands()
    mla_kernel._check_kernel(q, c_kv, k_rope)
    assert mla_kernel.mla_decode(q, c_kv, k_rope, valid, 0.1).shape == \
        (2, 4, 64)


def test_mla_decode_grid_plan():
    """A first-pass block an SM (132 on the H100), more where a block would
    otherwise take more than MAXT of the batch's tiles, up to GMAX."""
    assert mla_kernel.grid_plan(32, 2048, 132) == 132
    assert mla_kernel.grid_plan(32, 512, 132) == 132
    assert mla_kernel.grid_plan(4, 64, 1) == 1
    assert mla_kernel.grid_plan(128, 32768, 132) == 128 * 2048 // 64
    assert mla_kernel.grid_plan(8, 2048, 132 * 40) == 4096


def test_placed_mla_decode_keeps_the_up_projected_form(monkeypatch):
    """Placed operands (params and cache on a 1x1 mesh of a one-rank gloo
    group) keep the up-projected attention on each rank's heads
    (``_mla_attend``), so the dry-run's counts of the placed step do not
    move; the plain step attends in the latent space. Their logits agree
    at 2e-5 over a prefill and three decode steps."""
    cfg = get_config(DEEPSEEK).reduced()
    model = build_model(cfg)
    calls = {"_mla_attend": 0, "_mla_absorbed": 0}
    for name in calls:
        real = getattr(attention_mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(attention_mod, name, spy)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 11), dtype=np.int32))

    def run(params, cache, place):
        out = []
        with torch.no_grad(), implicit_replication():
            lg, pre = model.prefill(params, place(toks[:, :8],
                                                  PSpec(None, None)),
                                    max_len=32)
            out.append(lg)
            for dst, src in zip(tree_tensors(cache), tree_tensors(pre)):
                dst.copy_(src)
            before = dict(calls)
            for i in range(3):
                pos = place(torch.full((2,), 8 + i, dtype=torch.int32),
                            PSpec(None))
                lg, cache = model.decode_step(
                    params, place(toks[:, 8 + i:9 + i], PSpec(None, None)),
                    cache, pos)
                out.append(lg)
        return out, {k: calls[k] - before[k] for k in calls}

    plain, plain_calls = run(model.init(torch.Generator().manual_seed(0)),
                             model.init_cache(2, 32, device="cpu"),
                             lambda t, s: t)
    assert plain_calls == {"_mla_attend": 0,
                           "_mla_absorbed": 3 * cfg.num_layers}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        cache = model.init_cache(2, 32, device="cpu")
        placed, placed_calls = run(
            with_sharding(params, param_pspecs(params, mesh), mesh),
            with_sharding(cache, cache_pspecs(cache, mesh, 2), mesh),
            lambda t, s: with_sharding(t, s, mesh))
        placed = [t.full_tensor() for t in placed]
    finally:
        dist.destroy_process_group()
    assert placed_calls == {"_mla_attend": 3 * cfg.num_layers,
                            "_mla_absorbed": 0}
    for a, b in zip(placed, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)
