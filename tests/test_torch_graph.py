"""``TorchBackend``'s graph path on the CPU, where its step bodies run
eagerly: the decode body against the static cache equals the eager
``decode_step`` on a copy of the cache, bit for bit; the backend as a whole
matches ``JaxBackend`` on the same weights through the same batch plans,
within the fp32 decode tolerance of ``tests/test_models_smoke.py`` (1e-3);
and the launch-count arithmetic that stands in for a replay's launches.
The graphs themselves (capture and replay) run only on the card, in
``tests/test_torch_cuda.py``."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.energy import H100 as JAX_H100
from repro.serving.engine import JaxBackend
from repro.serving.request import Request as JaxRequest
from repro.serving.scheduler import BatchPlan as JaxBatchPlan
from repro_torch.configs import get_config
from repro_torch.energy import H100
from repro_torch.kernels import (add_launch_counts, launch_counts,
                                 reset_launch_counts)
from repro_torch.models import tree_clone, tree_tensors
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import BatchPlan, Request, TorchBackend
from repro_torch.serving.engine import PREFILL_BUCKETS
from repro_torch.serving.graphs import StepGraph

ARCHS = ["llama3-3b", "mamba2-1.3b", "recurrentgemma-9b",
         "deepseek-v2-lite-16b", "llama4-scout-17b-a16e"]
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)


def _cfg(arch, dtype="float32"):
    cfg = get_config(arch).reduced().replace(dtype=dtype, param_dtype=dtype)
    if cfg.arch_type == "hybrid":           # a (rec, rec, attn) unit and a tail
        cfg = cfg.replace(num_layers=5)
    return cfg


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_body_on_the_static_cache_matches_eager(arch, dtype):
    """Four steps of the decode graph's body (eager on the CPU) against
    ``decode_step`` on a copy of the same random cache: logits and every
    cache tensor equal (deepseek's: its prefix layer's latents and the
    stacked ones). The hybrid's rows at 29 and 30 cross its 32-slot
    ring."""
    cfg = _cfg(arch, dtype)
    backend = TorchBackend(cfg, max_batch=4, cache_len=64, device="cpu")
    assert backend.decode_graph.graph is None      # eager on the CPU
    gen = torch.Generator().manual_seed(0)
    for t in tree_tensors(backend.cache):
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    ref = tree_clone(backend.cache)
    start = np.array([3, 29, 30, 59])
    with torch.no_grad():
        for step in range(4):
            pos = torch.from_numpy(start + step)
            backend.pos.copy_(pos)
            got = backend.decode_graph()
            want, ref = backend.model.decode_step(backend.params,
                                                  backend.token, ref, pos)
            assert torch.equal(got, want), step
            for a, b in zip(tree_tensors(backend.cache), tree_tensors(ref)):
                assert torch.equal(a, b), step


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_bodies_match_the_forward(arch):
    """Each prefill bucket's body is the forward of that many zero
    tokens."""
    cfg = _cfg(arch)
    backend = TorchBackend(cfg, max_batch=2, cache_len=32, device="cpu")
    assert tuple(backend.prefill_graphs) == PREFILL_BUCKETS
    with torch.no_grad():
        for n, graph in backend.prefill_graphs.items():
            want = backend.model.forward(
                backend.params, torch.zeros((1, n), dtype=torch.long))[0]
            assert torch.equal(graph(), want), n


def _plans(requests_cls, plan_cls):
    """The same iterations for both packages: (prefill [(request, new
    tokens)], decode [requests at their context lengths])."""
    def req(ctx):
        r = requests_cls(arrival_time=0.0, prompt_len=ctx, output_len=8)
        r.prefilled = ctx
        return r
    spec = [([40], []), ([], [40]), ([16], [41]), ([], [42, 16]),
            ([], [43, 17, 5]), ([3], [44, 18]), ([], [45, 19, 6, 60])]
    return [plan_cls(prefill=[(req(0), n) for n in pf],
                     decode=[req(c) for c in dec]) for pf, dec in spec]


@pytest.mark.parametrize("arch", ARCHS)
def test_backend_matches_jax_backend(arch):
    """``TorchBackend`` on the CPU and ``JaxBackend`` on the same weights
    (converted through ``from_jax_params``) run the same batch plans: every
    decode step's logits within 1e-3, and both report a positive time and
    energy for every iteration."""
    jcfg = jax_get_config(arch).reduced()
    if jcfg.arch_type == "hybrid":
        jcfg = jcfg.replace(num_layers=5)
    jb = JaxBackend(jcfg, JAX_H100, max_batch=4, cache_len=64)
    tb = TorchBackend(_cfg(arch), H100, max_batch=4, cache_len=64,
                      device="cpu",
                      params=from_jax_params(
                          jax.tree.map(np.asarray, jb.params), device="cpu"))
    jax_logits = []
    decode = jb._decode

    def recording(*args):
        out = decode(*args)
        jax_logits.append(np.asarray(out[0]))
        return out

    jb._decode = recording
    torch_logits = []
    for jplan, tplan in zip(_plans(JaxRequest, JaxBatchPlan),
                            _plans(Request, BatchPlan)):
        jt = jb.execute(jplan, JAX_H100.f_max)
        tt = tb.execute(tplan, H100.f_max)
        assert min(jt) > 0 and min(tt) > 0
        if tplan.decode:
            torch_logits.append(tb.logits.numpy())
    assert len(torch_logits) == len(jax_logits) == 6
    for t, j in zip(torch_logits, jax_logits):
        np.testing.assert_allclose(t, j, **DECODE_TOL)
    assert tb.prefill_lengths == [64, 16, 4]
    assert tb.decode_steps == 6


def test_add_launch_counts_is_captured_counts_times_replays():
    """A capture takes back the counts its wrappers added (it launched
    nothing); each replay adds them once more."""
    reset_launch_counts()
    captured = {"rmsnorm": 57, "rmsnorm_fused": 56, "decode_attention": 28}
    add_launch_counts(captured)               # what the capture's wrappers
    add_launch_counts(captured, -1)           # counted, and the take-back
    assert all(n == 0 for n in launch_counts().values())
    for _ in range(3):
        add_launch_counts(captured)
    add_launch_counts({"rglru_gated_step": 26}, 5)
    counts = launch_counts()
    assert counts["rmsnorm"] == 3 * 57 and counts["rmsnorm_fused"] == 3 * 56
    assert counts["decode_attention"] == 3 * 28
    assert counts["rglru_gated_step"] == 5 * 26
    assert counts["flash_attention"] == counts["ssd_scan"] == 0
    with pytest.raises(KeyError):
        add_launch_counts({"no_such_kernel": 1})
    reset_launch_counts()
    assert all(n == 0 for n in launch_counts().values())


def test_backend_refuses_an_encoder_decoder():
    """whisper-medium is driven through its model contract
    (``tests/test_torch_encdec.py``): its forward and prefill take frames,
    which no backend step has."""
    with pytest.raises(ValueError, match="model contract"):
        TorchBackend(get_config("whisper-medium").reduced(), device="cpu")


def test_step_graph_runs_eagerly_on_the_cpu():
    calls = []
    graph = StepGraph(lambda: calls.append(1) or len(calls),
                      torch.device("cpu"))
    assert calls == [] and graph.graph is None and graph.launches == {}
    assert graph() == 1 and graph() == 2
    assert graph.device_ms() is None            # no card: nothing timed
