"""The port's training substrate (``repro_torch.training``,
``repro_torch.data``, ``repro_torch.launch.train``), on the CPU: the tests
of ``tests/test_training.py`` run on the port, and the port against the
JAX package on the same numbers.

Bounds: AdamW fed the same params, gradients and state as JAX's for 10
steps within 1e-6 of each fp32 leaf's largest magnitude (both compute
every step in fp32, in the same order; the global norm sums its squares in
another order, so the clip's scale, and with it every moment, may differ by
an ULP, which is a large relative error for an element near 0: the first
run, per element at 1e-6, failed so on the moments, 2.2e-8 apart at 0.1),
and one bf16 ULP for bf16 leaves (a last-bit difference of the fp32 value
may round either way); the synthetic stream byte for byte (the same numpy
code); the losses of JAX's and the port's ``train`` on the same weights
and stream within 1e-4 relative over 3 steps (fp32 gradients that agree to
1e-4, ``tests/test_torch_grads.py``, move the weights apart by less).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import synthetic_token_batches as jax_batches
from repro.models import build_model as jax_build_model
from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import adamw_update as jax_adamw_update
from repro.training import init_adamw as jax_init_adamw
from repro.training import train as jax_train
from repro_torch.configs import get_config
from repro_torch.data import synthetic_token_batches
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, tree_tensors
from repro_torch.models.convert import from_jax_params, to_tensor
from repro_torch.training import (AdamWConfig, adamw_update, init_adamw,
                                  load_checkpoint, make_train_step,
                                  save_checkpoint, train)
from repro_torch.training.train_loop import to_device


def _tiny(**kw):
    cfg = get_config("tinyllama-1.1b").reduced().replace(num_layers=2, **kw)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


# -- tests/test_training.py on the port ---------------------------------

def test_adamw_matches_reference_on_quadratic():
    """AdamW must descend f(w) = ||w||^2 quickly."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                      grad_clip=1e9)
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    state = init_adamw(params, cfg)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip_bounds_update():
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0,
                      warmup_steps=1)
    params = {"w": torch.zeros(4)}
    state = init_adamw(params, cfg)
    _, _, gnorm = adamw_update(cfg, params, {"w": torch.full((4,), 100.0)},
                               state)
    np.testing.assert_allclose(float(gnorm), 200.0, rtol=1e-5)


def test_train_loss_decreases_tiny_model():
    cfg, model, params = _tiny()
    data = synthetic_token_batches(cfg.vocab_size, 4, 32, seed=0)
    _, _, hist = train(model, params, data, steps=30,
                       opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=5),
                       log_every=29)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert [h["step"] for h in hist] == [1.0, 30.0]
    assert all(h["wall_s"] > 0 for h in hist)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_roundtrip(tmp_path, dtype):
    _, _, params = _tiny(dtype=dtype, param_dtype=dtype)
    opt = init_adamw(params)
    p = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(p, params, extra=opt)
    zeros = [torch.zeros_like(t) for t in tree_tensors(params)]
    template = {"leaves": zeros}
    loaded, extra = load_checkpoint(p[:-4], template, extra_template=opt)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
               zip(tree_tensors(params), tree_tensors(loaded)))
    assert any(t.dtype == getattr(torch, dtype) for t in loaded["leaves"])
    assert type(extra) is type(opt) and all(
        torch.equal(a, b) for a, b in zip(tree_tensors(opt),
                                          tree_tensors(extra)))
    with pytest.raises(ValueError):
        load_checkpoint(p, {"leaves": zeros[:-1]})


def test_data_pipeline_deterministic_and_learnable():
    it1 = synthetic_token_batches(100, 2, 16, seed=3)
    it2 = synthetic_token_batches(100, 2, 16, seed=3)
    b1, b2 = next(it1), next(it2)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == b1["labels"].shape == (2, 16)
    assert b1["tokens"].max() < 100


def test_train_step_counts_steps():
    cfg, model, params = _tiny()
    opt = init_adamw(params)
    step = make_train_step(model)
    b = to_device(next(synthetic_token_batches(cfg.vocab_size, 2, 16,
                                               seed=1)), "cpu")
    p1, o1, m1 = step(params, opt, b)
    p2, o2, m2 = step(p1, o1, b)
    assert int(m2["step"]) == 2
    assert torch.isfinite(m2["loss"])
    assert all(t.grad is None for t in tree_tensors(p2))


# -- against the JAX package ---------------------------------------------

def test_adamw_matches_jax():
    """10 steps from the same params, gradients and state: fp32 leaves
    and the moments within 1e-6 of the leaf's largest magnitude, bf16
    leaves within one bf16 ULP, the gradient norm within 1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 32), "b": (32,), "c": (3, 16, 8)}
    dtypes = {"a": np.float32, "b": np.float32, "c": jnp.bfloat16}
    jparams = {k: jnp.asarray(rng.normal(0, 1, s).astype(dtypes[k]))
               for k, s in shapes.items()}
    params = {k: to_tensor(np.asarray(v), "cpu") for k, v in
              jparams.items()}
    # warmup past step 10, and gradient norms on both sides of the clip
    cfg = dict(lr=1e-2, warmup_steps=4, grad_clip=20.0)
    jcfg, tcfg = JaxAdamWConfig(**cfg), AdamWConfig(**cfg)
    jstate, state = jax_init_adamw(jparams, jcfg), init_adamw(params, tcfg)
    for i in range(10):
        g = {k: rng.normal(0, 0.5 + i % 3, s).astype(dtypes[k])
             for k, s in shapes.items()}
        jparams, jstate, jn = jax_adamw_update(
            jcfg, jparams, {k: jnp.asarray(v) for k, v in g.items()},
            jstate)
        params, state, n = adamw_update(
            tcfg, params, {k: to_tensor(v, "cpu") for k, v in g.items()},
            state)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
        assert int(state.step) == int(jstate.step) == i + 1
        for k in shapes:
            want = np.asarray(jparams[k]).astype(np.float32)
            got = params[k].float().numpy()
            if dtypes[k] is np.float32:
                _close_to_leaf(got, want)
            else:
                ulp = np.abs(want) * 2.0 ** -7
                assert np.all(np.abs(got - want) <= ulp)
            for jm, tm in ((jstate.m, state.m), (jstate.v, state.v)):
                _close_to_leaf(tm[k].numpy(), np.asarray(jm[k]))


def _close_to_leaf(got, want, rtol=1e-6):
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def test_pipeline_matches_jax_byte_for_byte():
    for kw in ({}, {"with_frames": True, "frame_len": 6, "d_model": 8}):
        ours = synthetic_token_batches(300, 3, 20, seed=7, **kw)
        ref = jax_batches(300, 3, 20, seed=7, **kw)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()


def test_train_matches_jax():
    """JAX's ``train`` and the port's on the same weights and the same
    stream: every step's loss within 1e-4 relative."""
    jcfg = jax_get_config("tinyllama-1.1b").reduced().replace(num_layers=2)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    model = build_model(get_config("tinyllama-1.1b").reduced().replace(
        num_layers=2))
    opt = dict(lr=1e-3, warmup_steps=2)
    _, _, jhist = jax_train(jmodel, jparams,
                            jax_batches(jcfg.vocab_size, 2, 16, seed=0),
                            steps=3, opt_cfg=JaxAdamWConfig(**opt),
                            log_every=1)
    _, _, hist = train(model, params,
                       synthetic_token_batches(jcfg.vocab_size, 2, 16,
                                               seed=0),
                       steps=3, opt_cfg=AdamWConfig(**opt), log_every=1)
    assert len(hist) == len(jhist) == 3
    for h, j in zip(hist, jhist):
        assert h.keys() == j.keys()
        assert h["step"] == j["step"]
        np.testing.assert_allclose(h["loss"], j["loss"], rtol=1e-4)
        np.testing.assert_allclose(h["grad_norm"], j["grad_norm"],
                                   rtol=1e-4)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    ckpt, out = str(tmp_path / "ck.npz"), str(tmp_path / "hist.json")
    params, history = train_cli.main(
        ["--device", "cpu", "--reduced", "--steps", "3", "--batch", "2",
         "--seq", "16", "--checkpoint", ckpt, "--out", out])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[train] tinyllama-1.1b (reduced): ")
    assert [ln.split()[2] for ln in lines[1:3]] == ["0", "2"]
    assert lines[3] == f"[train] checkpoint -> {ckpt}"
    assert lines[4].startswith("[train] loss ")
    assert len(history) == 2 and os.path.exists(out)
    loaded, _ = load_checkpoint(ckpt, params)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_tensors(params), tree_tensors(loaded)))


def test_train_cli_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--reduced", "--steps", "1"])
