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
import repro.core
import repro.energy
import repro.serving
import repro.workloads
import repro_torch.configs
import repro_torch.core
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


def _payload(eng, tuner) -> dict:
    return {
        "trace": dict(TRACE),
        "freqs": [h["freq"] for h in tuner.history],
        "phases": [h["phase"] for h in tuner.history],
        "rounds": tuner.round,
        "energy_j": eng.metrics.c.energy_joules_total,
        "clock": eng.clock,
    }


def generate() -> dict:
    """The iteration-gated trajectory, through the port."""
    eng, tuner = _engine_and_tuner()
    eng.drain(policy=tuner)
    return _payload(eng, tuner)


def generate_tick() -> dict:
    """The pure POLICY_TICK trajectory, through the port."""
    eng, tuner = _engine_and_tuner()
    EventLoop([EngineNode(eng, tuner)], policy_tick_mode="tick").run()
    out = _payload(eng, tuner)
    out["mode"] = "tick"
    return out


def render(payload: dict) -> str:
    """The committed files' byte encoding (``tests/generate_golden.py``)."""
    return json.dumps(payload, indent=1)


#: the port's counterpart of ``generate_golden.GOLDENS``
GOLDENS = ((os.path.join(HERE, "golden_agft_decisions.json"), generate),
           (os.path.join(HERE, "golden_agft_decisions_tick.json"),
            generate_tick))


@pytest.mark.parametrize("mode,golden", [
    ("iteration", "golden_agft_decisions.json"),
    ("tick", "golden_agft_decisions_tick.json"),
])
def test_port_reproduces_committed_golden(mode, golden):
    fresh = render(generate() if mode == "iteration" else generate_tick())
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


def _routed(configs, core, energy, serving, workloads, spec):
    """The goldens' trace delivered to one engine through a routed
    ``EventLoop``: each request priced by ``NetworkModel(spec)`` and handed
    over from a ``DeliverySchedule`` on its ROUTE event."""
    eng = serving.InferenceEngine(configs.get_config("llama3-3b"),
                                  serving.EngineConfig(),
                                  initial_frequency=energy.A6000.f_max)
    tuner = core.AGFTTuner(energy.A6000)
    net = serving.NetworkModel.from_spec(spec, seed=5)
    sched = serving.DeliverySchedule()
    for req in sorted(workloads.generate_requests(
            workloads.PROTOTYPES[TRACE["workload"]], TRACE["n"],
            base_rate=TRACE["rate"], seed=TRACE["seed"]),
            key=lambda r: r.arrival_time):
        req.delivery_time = net.delivery_time(req.arrival_time)
        eng.inflight += 1
        sched.push(req.delivery_time, 0, req)
    serving.EventLoop([serving.EngineNode(eng, tuner)], router=sched).run()
    return eng, tuner


def test_routed_event_loop_matches_golden_and_reference():
    """The routed path the port once refused: through a zero-delay network
    it reproduces the committed golden byte for byte, and through ``wan``
    its trajectory equals ``repro``'s."""
    mods = (repro_torch.configs, repro_torch.core, repro_torch.energy,
            repro_torch.serving, repro_torch.workloads)
    eng, tuner = _routed(*mods, "zero")
    with open(os.path.join(HERE, "golden_agft_decisions.json")) as f:
        assert render(_payload(eng, tuner)) == f.read()
    ours = _routed(*mods, "wan")
    ref = _routed(repro.configs, repro.core, repro.energy, repro.serving,
                  repro.workloads, "wan")
    assert [_payload(*ours)] == [_payload(*ref)]
    assert len(ours[0].finished) == TRACE["n"]
    assert ours[0].metrics.c.energy_joules_total != \
        eng.metrics.c.energy_joules_total
