"""The port's copies of the JAX package's numpy stack, held to ``repro`` on
the same inputs, exactly: the Azure 2024/2023 traces, the input shapes and
``config_for_shape``, the per-phase EDP optima, the phased policies'
decision histories (``agft-2d``, ``greenllm-rule``), the fleet layer's
cluster summaries (hierarchy, network, faults, mixed hardware; event and
batched loops), and the serve CLI's JSON on the README's Quickstart lines.
One CPU run of ``agft-2d`` over a ``TorchBackend`` drives the phased path
that ``chip_smoke.py`` serves on the card."""
import dataclasses
import json
import os
import shlex
import sys

import pytest

import repro.configs
import repro.energy
import repro.launch.serve
import repro.policies
import repro.serving
import repro.serving.cluster
import repro.workloads
import repro_torch.configs
import repro_torch.energy
import repro_torch.launch.serve
import repro_torch.policies
import repro_torch.serving
import repro_torch.serving.cluster
import repro_torch.workloads
from repro_torch.serving import EngineConfig, InferenceEngine, TorchBackend
from test_torch_configs import jax_fields

PORT = (repro_torch.configs, repro_torch.energy, repro_torch.policies,
        repro_torch.serving, repro_torch.serving.cluster,
        repro_torch.workloads)
REF = (repro.configs, repro.energy, repro.policies, repro.serving,
       repro.serving.cluster, repro.workloads)


def _trace_rows(reqs):
    return [(r.arrival_time, r.prompt_len, r.output_len, r.template_id,
             r.template_frac) for r in reqs]


@pytest.mark.parametrize("year", [2023, 2024])
@pytest.mark.parametrize("seed", [0, 8, 21])
def test_azure_trace_equal(seed, year):
    ours = repro_torch.workloads.generate_azure_trace(
        1800.0, base_rate=2.0, year=year, seed=seed)
    ref = repro.workloads.generate_azure_trace(
        1800.0, base_rate=2.0, year=year, seed=seed)
    assert len(ours) > 100
    assert _trace_rows(ours) == _trace_rows(ref)
    assert repro_torch.workloads.azure_trace.MIX_2024 == \
        repro.workloads.azure_trace.MIX_2024
    assert repro_torch.workloads.azure_trace.MIX_2023 == \
        repro.workloads.azure_trace.MIX_2023


@pytest.mark.parametrize("arch", sorted(repro.configs.all_configs()))
def test_config_for_shape_equal(arch):
    assert sorted(repro_torch.configs.SHAPES) == sorted(repro.configs.SHAPES)
    for shape in repro.configs.SHAPES:
        assert dataclasses.asdict(repro_torch.configs.get_shape(shape)) == \
            dataclasses.asdict(repro.configs.get_shape(shape))
        assert jax_fields(
            repro_torch.configs.config_for_shape(arch, shape)) == \
            dataclasses.asdict(repro.configs.config_for_shape(arch, shape))
    assert repro_torch.configs.long_context_window(arch) == \
        repro.configs.long_context_window(arch)


@pytest.mark.parametrize("hw", ["A6000", "H100"])
@pytest.mark.parametrize("arch", ["llama3-3b", "mamba2-1.3b",
                                  "deepseek-v2-lite-16b"])
def test_phase_optimal_frequencies_equal(arch, hw):
    def optima(configs, energy):
        spec, cfg = getattr(energy, hw), configs.get_config(arch)
        return [energy.phase_optimal_frequencies(spec, cfg),
                energy.phase_optimal_frequencies(spec, cfg,
                                                 decode_seqs=4),
                energy.phase_optimal_frequencies(
                    spec, cfg, band=(spec.f_min, spec.f_max * 0.8))]

    ours = optima(repro_torch.configs, repro_torch.energy)
    assert ours == optima(repro.configs, repro.energy)
    assert all(isinstance(f, float) for pair in ours for f in pair)


def _phased_run(configs, energy, policies, serving, cluster, workloads,
                name, mode):
    eng = serving.InferenceEngine(configs.get_config("llama3-3b"),
                                  serving.EngineConfig(),
                                  initial_frequency=energy.A6000.f_max)
    eng.submit(workloads.generate_azure_trace(600.0, base_rate=2.0, seed=8))
    pol = policies.get_policy(name, hardware=energy.A6000)
    if mode == "iteration":
        eng.drain(policy=pol)
    else:
        serving.EventLoop([serving.EngineNode(eng, pol)],
                          policy_tick_mode="tick").run()
    return eng, pol


@pytest.mark.parametrize("mode", ["iteration", "tick"])
@pytest.mark.parametrize("name", ["agft-2d", "greenllm-rule"])
def test_phased_policy_histories_bit_equal(name, mode):
    eng, pol = _phased_run(*PORT, name, mode)
    jeng, jpol = _phased_run(*REF, name, mode)
    assert type(pol).__name__ == type(jpol).__name__
    assert len(pol.history) > 10 and pol.history == jpol.history
    assert eng.metrics.snapshot() == jeng.metrics.snapshot()
    assert (eng.clock, eng.frequency, eng.freq_targets) == \
        (jeng.clock, jeng.frequency, jeng.freq_targets)
    assert eng.freq_targets is not None
    assert len(eng.finished) == len(jeng.finished) > 0
    if name == "agft-2d":
        assert pol.round == jpol.round
        assert all(isinstance(h["freq"], tuple) for h in pol.history)


FLEETS = {
    "hierarchy-800w": dict(n_nodes=4, policies=["agft"] * 4,
                           fleet_policy=("hierarchy",
                                         {"power_cap_w": 800.0})),
    "wan-tick": dict(n_nodes=2, policies=["agft"] * 2, network="wan",
                     policy_tick_mode="tick"),
    "node-churn": dict(n_nodes=3, policies=["agft"] * 3,
                       faults="node-churn"),
    "mixed-energy": dict(n_nodes=4, policies=["agft"] * 4,
                         hardware="a6000,h100:2,l4", router="energy"),
}


def _cluster_summary(configs, energy, policies, serving, cluster,
                     workloads, fleet, step_mode):
    kw = dict(FLEETS[fleet])
    if "fleet_policy" in kw:
        name, args = kw["fleet_policy"]
        kw["fleet_policy"] = policies.get_policy(name, **args)
    if "hardware" in kw:
        kw["hardware"] = energy.parse_fleet_hardware(kw["hardware"],
                                                     kw["n_nodes"])
    cl = cluster.ServingCluster(configs.get_config("llama3-3b"),
                                step_mode=step_mode, **kw)
    cl.submit(workloads.generate_requests(workloads.PROTOTYPES["normal"],
                                          160, base_rate=6.0, seed=4))
    steps = cl.drain()
    return steps, dataclasses.asdict(cl.summary())


@pytest.mark.parametrize("fleet,step_mode", [
    ("hierarchy-800w", "event"), ("hierarchy-800w", "batched"),
    ("wan-tick", "event"), ("node-churn", "event"),
    ("mixed-energy", "event")])
def test_cluster_summary_equal(fleet, step_mode):
    ours = _cluster_summary(*PORT, fleet, step_mode)
    ref = _cluster_summary(*REF, fleet, step_mode)
    assert ours == ref
    assert ours[1]["finished"] > 0 and ours[1]["energy_j"] > 0


def _readme_quickstart():
    """The ``python -m repro.launch.serve`` lines of README.md's
    Quickstart, continuation lines joined, as argument lists."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "README.md")) as f:
        text = f.read()
    block = text.split("## Quickstart", 1)[1].split("```bash", 1)[1]
    block = block.split("```", 1)[0].replace("\\\n", " ")
    prefix = "python -m repro.launch.serve"
    return [shlex.split(line.strip()[len(prefix):])
            for line in block.splitlines()
            if line.strip().startswith(prefix)]


QUICKSTART = _readme_quickstart()


def _shorten(argv):
    """Each line at a size that runs in seconds: 150 requests, a 60 s
    Azure trace."""
    out, i = [], 0
    while i < len(argv):
        if argv[i] in ("--requests", "--duration"):
            i += 2
            continue
        out.append(argv[i])
        i += 1
    return out + ["--requests", "150", "--duration", "60"]


@pytest.mark.parametrize("argv", QUICKSTART,
                         ids=[" ".join(a) for a in QUICKSTART])
def test_serve_cli_json_equal(argv, monkeypatch, capsys):
    assert len(QUICKSTART) == 7
    outs = []
    for main in (repro_torch.launch.serve.main, repro.launch.serve.main):
        monkeypatch.setattr(sys, "argv", ["serve"] + _shorten(argv))
        main()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert json.loads(outs[0])["finished"] > 0


def test_agft_2d_on_a_cpu_torch_backend_over_an_azure_trace():
    """The phased path that ``chip_smoke.py`` runs on the card: ``agft-2d``
    drives an engine over a ``TorchBackend`` (a reduced tinyllama on the
    CPU), which has no ``execute_phased``, so each phased iteration runs at
    its dominant phase's clock. Every request finishes at its own length,
    the engine ends in phased mode, and the backend ran prefill forwards
    and decode steps."""
    cfg = repro_torch.configs.get_config("tinyllama-1.1b").reduced()
    H100 = repro_torch.energy.H100
    backend = TorchBackend(cfg, H100, max_batch=4, cache_len=128,
                           device="cpu")
    eng = InferenceEngine(cfg, EngineConfig(max_num_seqs=4),
                          hardware=H100, backend=backend)
    reqs = repro_torch.workloads.generate_azure_trace(3.0, base_rate=1.0,
                                                      seed=0)
    assert len(reqs) >= 2
    eng.submit(reqs)
    pol = repro_torch.policies.get_policy("agft-2d", hardware=H100)
    eng.drain(policy=pol)
    assert len(eng.finished) == len(reqs)
    assert all(r.generated == r.output_len for r in eng.finished)
    assert pol.history and all(isinstance(h["freq"], tuple)
                               for h in pol.history)
    assert isinstance(eng.freq_targets, tuple) and \
        len(eng.freq_targets) == 2
    assert backend.prefill_steps > 0 and backend.decode_steps > 0
