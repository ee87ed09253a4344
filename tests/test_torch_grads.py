"""The port's training half against ``repro.models`` on the same weights:
each family's ``loss`` and its gradient (``loss.backward()``) against JAX's
``value_and_grad`` of ``model.loss``, the JAX init exported as numpy arrays
and converted by ``repro_torch.models.convert`` (JAX's gradient tree too).
Every arch of ``tests/test_models_smoke.py::ALL_ARCHS``, reduced and fp32
on the CPU, and llama4-scout with the capacity dispatch; tokens and
whisper's frames from a seeded numpy generator.

Bounds, fixed before the first run: the loss within 2e-5 relative of
JAX's, each gradient leaf within a relative L2 of 1e-4 (fp32 sums in
another order; the largest is printed). ``remat`` on and off must give the
same gradients bit for bit (the recomputed forward runs the same ops on
the same inputs). The kernel wrappers refuse autograd (``RuntimeError``)
where JAX cannot differentiate the Pallas kernels.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model, tree_tensors
from repro_torch.models.blocks import widened_leaves
from repro_torch.models.convert import from_jax_params
from repro_torch.training import AdamWConfig, init_adamw, make_train_step
from repro_torch.training.train_loop import to_device
from test_models_smoke import ALL_ARCHS

LOSS_RTOL = 2e-5
GRAD_REL_L2 = 1e-4
B, S = 2, 16
# every arch of the smoke tests, and llama4-scout's capacity dispatch
CASES = [(a, {}) for a in ALL_ARCHS] + [
    ("llama4-scout-17b-a16e", {"moe_dispatch": "capacity"})]


def _ids(case):
    arch, kw = case
    return "-".join([arch] + [f"{k}={v}" for k, v in kw.items()])


def _inputs(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    extra = ()
    if cfg.is_encoder_decoder:
        extra = (rng.normal(0, 1, (B, cfg.encoder_seq, cfg.d_model))
                 .astype(np.float32),)
    return (toks[:, :-1], toks[:, 1:]) + extra


@functools.lru_cache(maxsize=None)
def _jax_case(arch, kw):
    """JAX's params (numpy), inputs, loss and gradient tree (numpy)."""
    cfg = jax_get_config(arch).reduced().replace(**dict(kw))
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    args = _inputs(cfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, *map(jnp.asarray, args))))(params)
    return (jax.tree.map(np.asarray, params), args, float(loss),
            jax.tree.map(np.asarray, grads))


def _port(arch, kw, **extra):
    """The port's model on JAX's weights (requiring grad), and the inputs."""
    params, args, _, _ = _jax_case(arch, tuple(sorted(kw.items())))
    cfg = get_config(arch).reduced().replace(**kw, **extra)
    tparams = from_jax_params(params, device="cpu")
    for t in tree_tensors(tparams):
        t.requires_grad_(True)
    return build_model(cfg), tparams, [torch.from_numpy(a) for a in args]


def _rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_loss_and_grads_match_jax(case):
    arch, kw = case
    _, _, jloss, jgrads = _jax_case(arch, tuple(sorted(kw.items())))
    model, params, args = _port(arch, kw)
    loss = model.loss(params, *args)
    loss.backward()
    assert abs(loss.item() - jloss) <= LOSS_RTOL * abs(jloss)
    want = list(tree_tensors(from_jax_params(jgrads, device="cpu")))
    got = [t.grad for t in tree_tensors(params)]
    assert len(got) == len(want) and all(g is not None for g in got)
    errs = [_rel_l2(g, w) for g, w in zip(got, want)]
    worst = int(np.argmax(errs))
    print(f"{_ids(case)}: loss {loss.item():.7f} (JAX {jloss:.7f}); "
          f"worst leaf rel-L2 {errs[worst]:.3e} {tuple(want[worst].shape)}")
    assert max(errs) <= GRAD_REL_L2


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_remat_on_and_off_give_equal_grads(case):
    arch, kw = case
    grads = []
    for remat in (True, False):
        model, params, args = _port(arch, kw, remat=remat)
        model.loss(params, *args).backward()
        grads.append([t.grad for t in tree_tensors(params)])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_remat_keeps_only_layer_inputs():
    """With remat the backward graph keeps fewer saved activations: the
    forward's saved tensors counted through autograd's pack hook."""
    def saved(remat):
        model, params, args = _port("llama3-3b", {}, remat=remat)
        count = [0]

        def pack(t):
            count[0] += t.numel()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model.loss(params, *args)
        return count[0]

    assert saved(True) < saved(False)


def test_whisper_encoder_leaves_get_gradients():
    model, params, args = _port("whisper-medium", {})
    model.loss(params, *args).backward()
    enc = list(tree_tensors(params["enc_layers"])) + list(
        tree_tensors(params["enc_final_norm"]))
    assert enc and all(t.grad is not None and bool(t.grad.abs().sum() > 0)
                       for t in enc)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "whisper-medium"])
def test_loss_through_the_kernels_refuses_autograd(arch):
    """JAX cannot differentiate its Pallas kernels: ``value_and_grad``
    raises (a ``ValueError`` from linearization, or an ``AssertionError``
    from the kernel's jvp rule inside ``jax.checkpoint``); the port's kernel
    wrappers refuse to (``RuntimeError``), on the CPU too, where they would
    run their plain versions."""
    jcfg = jax_get_config(arch).reduced().replace(use_pallas=True)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    args = _inputs(jcfg)
    with pytest.raises((ValueError, AssertionError)):
        jax.value_and_grad(
            lambda p: jmodel.loss(p, *map(jnp.asarray, args)))(jparams)
    model, params, targs = _port(arch, {}, use_pallas=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        model.loss(params, *targs)
    with torch.no_grad():                  # serving: the kernels run
        assert torch.isfinite(model.loss(params, *targs))


def _wrapper_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    x, w = r(2, 8, 64), r(64)
    q, k, v = r(1, 8, 4, 64), r(1, 8, 2, 64), r(1, 8, 2, 64)
    valid = torch.ones((1, 8), dtype=torch.bool)
    sx, sdt = r(1, 8, 2, 16), torch.rand(1, 8, 2, generator=g)
    sA, sB, sC = -torch.rand(2, generator=g), r(1, 8, 1, 16), r(1, 8, 1, 16)
    lx, la, h0 = r(1, 8, 32), -torch.rand(1, 8, 32, generator=g), r(1, 32)
    lam = torch.rand(32, generator=g)
    return {
        "rmsnorm": (ops.rmsnorm, ref.rmsnorm, (x, w)),
        "add_rmsnorm": (ops.add_rmsnorm, ref.add_rmsnorm, (x, x + 1, w)),
        "flash_attention": (ops.flash_attention, ref.flash_attention,
                            (q, k, v)),
        "decode_attention": (ops.decode_attention, ref.decode_attention,
                             (q[:, :1], k, v, valid)),
        "ssd_scan": (ops.ssd_scan, ref.ssd_scan, (sx, sdt, sA, sB, sC)),
        "rglru_scan": (ops.rglru_scan, ref.rglru_scan, (lx, la, h0)),
        "rglru_gated_scan": (ops.rglru_gated_scan, ref.rglru_gated_scan,
                             (lx, lx, lx, lam, lx, h0)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_cases()))
def test_each_kernel_wrapper_refuses_autograd(name):
    """Each of the seven wrappers raises, naming itself, where autograd
    records and an input requires grad; under ``torch.no_grad()`` it runs,
    and its plain version stays differentiable."""
    wrapper, plain, args = _wrapper_cases()[name]
    for i in [i for i, a in enumerate(args) if a.is_floating_point()]:
        call = [a.clone().requires_grad_(j == i) if a.is_floating_point()
                else a for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match=f"^{name} has no gradient"):
            wrapper(*call)
        with torch.no_grad():
            wrapper(*call)
        outs = plain(*call)
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum(o.float().sum() for o in outs).backward()
        assert call[i].grad is not None


def test_bf16_gate_weights_stay_on_the_bf16_grid():
    """The RG-LRU gate weights, held widened to fp32 (``GATES_FP32``),
    keep bf16 values through training, as JAX's bf16 leaves do."""
    cfg = get_config("recurrentgemma-9b").reduced().replace(
        dtype="bfloat16", param_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    gates = widened_leaves(params, cfg)     # 2 rec layers, 2 gates each
    assert len(gates) == 4 and all(
        t.dtype == torch.float32 for t in gates)
    before = [t.clone() for t in gates]
    step = make_train_step(model, AdamWConfig(lr=1e-2, warmup_steps=1))
    opt = init_adamw(params)
    rng = np.random.default_rng(0)
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
        batch = to_device({"tokens": toks[:, :-1], "labels": toks[:, 1:]},
                          "cpu")
        params, opt, metrics = step(params, opt, batch)
    assert int(metrics["step"]) == 3
    assert all(not torch.equal(a, b) for a, b in zip(gates, before))
    assert all(torch.equal(t, t.to(torch.bfloat16).float()) for t in gates)
    assert widened_leaves(params, cfg.replace(param_dtype="float32")) == []
