"""The port's copies of the numpy serving, tuning and energy stack
reproduce both committed AGFT goldens byte for byte: the scenario of
``tests/generate_golden.py`` (llama3-3b on the A6000 model, 150 ``normal``
requests) through the port's ``SimBackend`` engine, ``AGFTTuner`` and
``EventLoop``, in iteration mode and in ``policy_tick_mode="tick"``. The
engine's per-iteration clock, energy and power also equal the reference's
bit for bit."""
import json
import os

import pytest

import repro.configs
import repro.energy
import repro.serving
import repro.workloads
import repro_torch.configs
import repro_torch.energy
import repro_torch.serving
import repro_torch.workloads
from repro_torch.configs import get_config
from repro_torch.core import AGFTTuner
from repro_torch.energy import A6000
from repro_torch.serving import (EngineConfig, EngineNode, EventLoop,
                                 InferenceEngine)
from repro_torch.workloads import PROTOTYPES, generate_requests

HERE = os.path.dirname(os.path.abspath(__file__))
TRACE = {"workload": "normal", "n": 150, "rate": 3.0, "seed": 7}


def _engine_and_tuner():
    eng = InferenceEngine(get_config("llama3-3b"), EngineConfig(),
                          initial_frequency=A6000.f_max)
    eng.submit(generate_requests(PROTOTYPES[TRACE["workload"]], TRACE["n"],
                                 base_rate=TRACE["rate"],
                                 seed=TRACE["seed"]))
    return eng, AGFTTuner(A6000)


def _render(eng, tuner, mode=None) -> str:
    out = {
        "trace": dict(TRACE),
        "freqs": [h["freq"] for h in tuner.history],
        "phases": [h["phase"] for h in tuner.history],
        "rounds": tuner.round,
        "energy_j": eng.metrics.c.energy_joules_total,
        "clock": eng.clock,
    }
    if mode:
        out["mode"] = mode
    return json.dumps(out, indent=1)


@pytest.mark.parametrize("mode,golden", [
    ("iteration", "golden_agft_decisions.json"),
    ("tick", "golden_agft_decisions_tick.json"),
])
def test_port_reproduces_committed_golden(mode, golden):
    eng, tuner = _engine_and_tuner()
    if mode == "iteration":
        eng.drain(policy=tuner)
        fresh = _render(eng, tuner)
    else:
        EventLoop([EngineNode(eng, tuner)], policy_tick_mode="tick").run()
        fresh = _render(eng, tuner, mode="tick")
    with open(os.path.join(HERE, golden)) as f:
        assert fresh == f.read()


@pytest.mark.parametrize("arch,hw", [("llama3-3b", "A6000"),
                                     ("tinyllama-1.1b", "H100")])
def test_sim_engine_iterations_bit_equal_to_reference(arch, hw):
    """Per-iteration (clock, energy, power, frequency) of the port's
    SimBackend engine equal ``repro``'s bit for bit on a seeded workload,
    under a clock that changes every iteration."""

    def run(configs, energy, serving, workloads):
        spec = getattr(energy, hw)
        eng = serving.InferenceEngine(configs.get_config(arch),
                                      serving.EngineConfig(), hardware=spec)
        eng.submit(workloads.generate_requests(
            workloads.PROTOTYPES["high_concurrency"], 60, base_rate=8.0,
            seed=3))
        trace = []
        while eng.has_work and len(trace) < 3000:
            eng.step()
            eng.set_frequency(spec.f_min + (len(trace) * 37.0) % (
                spec.f_max - spec.f_min))
            c = eng.metrics.c
            trace.append((eng.clock, c.energy_joules_total,
                          c.current_power_watts, eng.frequency))
        return trace

    ours = run(repro_torch.configs, repro_torch.energy, repro_torch.serving,
               repro_torch.workloads)
    ref = run(repro.configs, repro.energy, repro.serving, repro.workloads)
    assert len(ours) > 100
    assert ours == ref


def test_unported_network_paths_raise():
    eng, tuner = _engine_and_tuner()
    with pytest.raises(NotImplementedError):
        EventLoop([EngineNode(eng, tuner)], router=object())
