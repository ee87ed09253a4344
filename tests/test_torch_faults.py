"""Fault-injection subsystem tests (repro_torch.serving.faults + event core):
spec grammar, per-node RNG stream independence, zero-fault byte-identity
against BOTH committed goldens, the request-conservation property
(submitted == finished + dropped + in-system at every event-loop step,
with a hypothesis variant when the library is installed), node-churn
retry/re-route vs the naive no-retry baseline, AGFT graceful degradation
(bank freeze on dropped telemetry, stuck-DVFS divergence hold), thermal
throttle clamping, deadline load shedding, and the batched-path guard."""
import json
import os

import pytest

from repro_torch.configs import get_config
from repro_torch.core import AGFTTuner
from repro_torch.energy import A6000
from repro_torch.serving import (EngineConfig, EngineNode, EventLoop,
                           InferenceEngine)
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.faults import (PRESETS, FaultConfig, FaultModel,
                                  NodeFaultState, parse_fault_spec)
from repro_torch.serving.request import RequestState
from repro_torch.workloads import PROTOTYPES, generate_requests

CFG = get_config("llama3-3b")
HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden_agft_decisions.json")
GOLDEN_TICK = os.path.join(HERE, "golden_agft_decisions_tick.json")


def trace(n=80, rate=3.0, seed=21, workload="normal"):
    return generate_requests(PROTOTYPES[workload], n, base_rate=rate,
                             seed=seed)


# ---------------------------------------------------------------------------
# spec grammar
# ---------------------------------------------------------------------------

class TestSpecParsing:
    def test_presets_resolve_to_their_configs(self):
        for name, cfg in PRESETS.items():
            assert parse_fault_spec(name) == cfg
        assert not parse_fault_spec("none").any_active

    def test_clause_grammar(self):
        cfg = parse_fault_spec(
            "crash:mttf=60,mttr=5,retries=2,backoff=0.5;"
            "dvfs:stick=0.1,lag=0.01;thermal:mtbf=30,duration=4,cap=0.5;"
            "telemetry:drop=0.2")
        assert cfg == FaultConfig(
            crash_mttf_s=60.0, crash_mttr_s=5.0, retry_budget=2,
            retry_backoff_s=0.5, dvfs_stick_prob=0.1, dvfs_lag_s=0.01,
            thermal_mtbf_s=30.0, thermal_duration_s=4.0,
            thermal_cap_frac=0.5, telemetry_drop_prob=0.2)

    def test_preset_plus_override(self):
        cfg = parse_fault_spec("node-churn;crash:retries=0")
        assert cfg.crash_mttf_s == PRESETS["node-churn"].crash_mttf_s
        assert cfg.retry_budget == 0

    @pytest.mark.parametrize("bad", [
        "bogus", "crash", "crash:mttf", "crash:nope=1",
        "dvfs:stick=2.0", "telemetry:drop=-0.5",
        "crash:mttf=60,retries=-1",
    ])
    def test_rejects_bad_specs(self, bad):
        with pytest.raises(ValueError):
            parse_fault_spec(bad)


# ---------------------------------------------------------------------------
# per-node RNG streams: membership changes never shift a peer's schedule
# ---------------------------------------------------------------------------

class TestStreamIndependence:
    @staticmethod
    def _first_onsets(n_nodes, spec="node-churn;thermal:mtbf=45", seed=9):
        engines = [InferenceEngine(CFG, EngineConfig(),
                                   initial_frequency=A6000.f_max)
                   for _ in range(n_nodes)]
        fm = FaultModel.from_spec(spec, seed=seed)
        fm.bind(engines)
        first = {}
        for t, _, node, action in sorted(fm._heap):
            first.setdefault((node, action.kind), t)
        return first

    def test_bound_schedules_are_per_node_pure(self):
        two, three = self._first_onsets(2), self._first_onsets(3)
        for key, t in two.items():
            assert three[key] == t      # nodes 0/1 unchanged by node 2

    def test_telemetry_stream_replays_per_node(self):
        # a fresh state for the SAME (seed, node) replays identically,
        # whatever other nodes exist around it
        cfg = parse_fault_spec("lossy-telemetry")
        a, b = (NodeFaultState(1, cfg, seed=5) for _ in range(2))
        assert ([a.scrape_dropped(float(i)) for i in range(20)]
                == [b.scrape_dropped(float(i)) for i in range(20)])
        assert a.scrape_drops > 0          # the stream actually drops

    def test_seed_changes_the_schedule(self):
        cfg = parse_fault_spec("node-churn")
        a = NodeFaultState(0, cfg, seed=1).sample_crash_gap()
        b = NodeFaultState(0, cfg, seed=2).sample_crash_gap()
        assert a != b


# ---------------------------------------------------------------------------
# zero-fault byte-identity: both committed goldens
# ---------------------------------------------------------------------------

def _golden_run(policy_tick_mode):
    """The goldens' pinned trace (normal/150/3.0/seed 7) driven through
    an EventLoop with an attached-but-inactive FaultModel."""
    eng = InferenceEngine(CFG, EngineConfig(),
                          initial_frequency=A6000.f_max)
    eng.submit(generate_requests(PROTOTYPES["normal"], 150, base_rate=3.0,
                                 seed=7))
    tuner = AGFTTuner(A6000)
    fm = FaultModel(PRESETS["none"])
    assert not fm.active
    EventLoop([EngineNode(eng, tuner)], policy_tick_mode=policy_tick_mode,
              fault_model=fm).run()
    return eng, tuner


@pytest.mark.parametrize("mode,path", [("iteration", GOLDEN),
                                       ("tick", GOLDEN_TICK)])
def test_zero_fault_matches_committed_golden(mode, path):
    eng, tuner = _golden_run(mode)
    with open(path) as f:
        golden = json.load(f)
    assert [h["freq"] for h in tuner.history] == golden["freqs"]
    assert [h["phase"] for h in tuner.history] == golden["phases"]
    assert tuner.round == golden["rounds"]
    assert eng.metrics.c.energy_joules_total == golden["energy_j"]
    assert eng.clock == golden["clock"]


# ---------------------------------------------------------------------------
# conservation: submitted == finished + dropped + in-system, every step
# ---------------------------------------------------------------------------

def _total_accounted(cl):
    fin = sum(len(e.finished) for e in cl.engines)
    dropped = sum(len(e.sched.dropped) for e in cl.engines)
    if cl.faults is not None:
        dropped += cl.faults.drops
    in_system = sum(len(e.sched.waiting) + len(e.sched.running)
                    + len(e._pending) for e in cl.engines)
    in_flight = (len(cl._deliveries) if cl._deliveries is not None else 0)
    return fin + dropped + in_system + in_flight


def _assert_conserved(spec, fault_seed, n=60, nodes=2):
    cl = ServingCluster(CFG, n_nodes=nodes, policies=[None] * nodes,
                        faults=spec, fault_seed=fault_seed)
    cl.submit(trace(n, rate=4.0, seed=3))
    loop = EventLoop(cl.nodes, router=cl._deliveries,
                     fault_model=cl.faults)
    cl._loop = loop
    audited = [0]

    def audit(lp, kind, t):
        audited[0] += 1
        assert _total_accounted(cl) == cl.submitted

    loop.on_event = audit
    loop.run()
    assert audited[0] > 0
    assert _total_accounted(cl) == cl.submitted
    s = cl.summary()
    # fully drained: every request either finished or was dropped
    assert s.finished + s.dropped_total == s.submitted


CONSERVATION_CASES = [
    ("node-churn", 0),
    ("node-churn;crash:retries=0", 0),
    ("node-churn;crash:mttf=15,mttr=3", 2),
    ("node-churn;telemetry:drop=0.3;dvfs:stick=0.2", 1),
]


@pytest.mark.parametrize("spec,seed", CONSERVATION_CASES)
def test_conservation_at_every_event(spec, seed):
    _assert_conserved(spec, seed)


def test_conservation_property_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=6, deadline=None)
    @given(st.integers(min_value=0, max_value=50),
           st.sampled_from(["node-churn",
                            "node-churn;crash:retries=0",
                            "node-churn;crash:mttf=20,mttr=4"]))
    def inner(fault_seed, spec):
        _assert_conserved(spec, fault_seed, n=40)

    inner()


# ---------------------------------------------------------------------------
# node churn: resilient retries vs the naive no-retry baseline
# ---------------------------------------------------------------------------

def _churn_summary(retries, n=250, nodes=3, seed=0):
    cl = ServingCluster(CFG, n_nodes=nodes, policies=[None] * nodes,
                        faults=f"node-churn;crash:retries={retries}",
                        fault_seed=seed)
    cl.submit(trace(n, rate=3.0, seed=11))
    cl.drain()
    return cl.summary()


def test_churn_resilient_completes_all_non_dropped():
    s = _churn_summary(retries=4)
    assert s.fault_counters["crashes"] > 0
    assert s.fault_counters["reroutes"] > 0
    assert s.finished + s.dropped_total == s.submitted
    assert s.completion_rate == 1.0

def test_churn_naive_no_retry_loses_requests():
    s = _churn_summary(retries=0)
    assert s.fault_counters["crashes"] > 0
    assert s.dropped_total > 0                  # provably lossy
    assert s.finished < s.submitted
    assert s.finished + s.dropped_total == s.submitted
    # dropped requests are terminally marked
    assert s.fault_counters["dropped_retry"] == s.dropped_total


def test_rerouted_requests_carry_retry_counts():
    cl = ServingCluster(CFG, n_nodes=3, policies=[None] * 3,
                        faults="node-churn")
    reqs = trace(250, rate=3.0, seed=11)
    cl.submit(reqs)
    cl.drain()
    assert cl.faults.reroutes > 0
    assert any(r.retries > 0 for r in reqs)
    assert all(r.state is RequestState.FINISHED for r in reqs
               if r.retries > 0)


# ---------------------------------------------------------------------------
# AGFT graceful degradation: frozen bank, stuck-DVFS hold
# ---------------------------------------------------------------------------

def test_bank_frozen_on_full_telemetry_dropout():
    """drop=1.0: every scrape fails, so the resilient tuner must never
    credit a window — zero LinUCB updates, zero rounds, fault-hold rows."""
    cl = ServingCluster(CFG, n_nodes=2, policies=["agft"] * 2,
                        faults="telemetry:drop=1.0")
    cl.submit(trace(80))
    cl.drain()
    for p in cl.policies:
        assert p.round == 0
        assert all(arm.n == 0 for arm in p.bank.arms.values())
        assert any(h["phase"] == "fault-hold" for h in p.history)
    s = cl.summary()
    assert s.fault_counters["telemetry_drops"] > 0
    assert s.finished == s.submitted


def test_naive_tuner_learns_from_corrupted_windows():
    """The agft-naive baseline (fault_aware=False) keeps updating its
    bank under total telemetry loss — the poisoning the resilient path
    refuses."""
    cl = ServingCluster(CFG, n_nodes=2, policies=["agft-naive"] * 2,
                        faults="telemetry:drop=1.0")
    cl.submit(trace(80))
    cl.drain()
    assert any(p.round > 0 for p in cl.policies)


def test_stuck_dvfs_holds_and_never_poisons():
    """stick=1.0: no actuation ever lands. The tuner must detect the
    divergence (telemetry frequency != chosen action), keep re-issuing,
    and never credit a window executed at the wrong frequency."""
    cl = ServingCluster(CFG, n_nodes=1, policies=["agft"],
                        faults="dvfs:stick=1.0")
    cl.submit(trace(60))
    cl.drain()
    eng, p = cl.engines[0], cl.policies[0]
    assert eng.frequency == A6000.f_max     # nothing ever landed
    for f, arm in p.bank.arms.items():
        if f != A6000.f_max:
            assert arm.n == 0               # no phantom-frequency credit
    assert cl.summary().fault_counters["dvfs_sticks"] > 0


# ---------------------------------------------------------------------------
# thermal throttling
# ---------------------------------------------------------------------------

def test_thermal_cap_clamps_frequency_for_the_window():
    cl = ServingCluster(CFG, n_nodes=2, policies=["agft"] * 2,
                        faults="thermal:mtbf=10,duration=5,cap=0.5")
    cl.submit(trace(150))
    loop = EventLoop(cl.nodes, router=cl._deliveries,
                     fault_model=cl.faults)
    cl._loop = loop
    throttled_seen = [0]

    def audit(lp, kind, t):
        for eng, st in zip(cl.engines, cl.faults.states):
            if st.thermal_cap_mhz is not None:
                throttled_seen[0] += 1
                assert eng.frequency <= st.thermal_cap_mhz

    loop.on_event = audit
    loop.run()
    assert cl.faults.thermal_events > 0
    assert throttled_seen[0] > 0
    s = cl.summary()
    assert s.finished == s.submitted


# ---------------------------------------------------------------------------
# deadline load shedding
# ---------------------------------------------------------------------------

def test_deadline_sheds_are_counted_everywhere():
    reqs = trace(120, rate=30.0, seed=5)     # hard overload burst
    for r in reqs:
        r.deadline_s = 0.5
    eng = InferenceEngine(CFG, EngineConfig(max_num_seqs=4),
                          initial_frequency=A6000.f_min)
    eng.submit(reqs)
    eng.drain()
    dropped = len(eng.sched.dropped)
    assert dropped > 0
    assert len(eng.finished) + dropped == len(reqs)
    assert all(r.state is RequestState.DROPPED for r in eng.sched.dropped)
    assert eng.metrics.c.requests_dropped_total == dropped
    snap = eng.metrics.snapshot()
    assert snap["vllm:requests_dropped_total"] == dropped


def test_deadlines_without_faults_count_in_cluster_summary():
    reqs = trace(120, rate=30.0, seed=5)
    for r in reqs:
        r.deadline_s = 0.5
    cl = ServingCluster(CFG, n_nodes=1, policies=[None],
                        engine_cfg=EngineConfig(max_num_seqs=4))
    cl.engines[0].set_frequency(A6000.f_min)
    cl.submit(reqs)
    cl.drain()
    s = cl.summary()
    assert s.dropped_total > 0
    assert s.finished + s.dropped_total == s.submitted
    assert s.completion_rate == 1.0        # of the non-shed requests


def test_no_deadline_trace_never_sheds():
    eng = InferenceEngine(CFG, EngineConfig(),
                          initial_frequency=A6000.f_max)
    eng.submit(trace(60))
    eng.drain()
    assert not eng.sched.dropped
    assert eng.metrics.c.requests_dropped_total == 0


# ---------------------------------------------------------------------------
# batched path: active fault models are rejected, inactive ones ignored
# ---------------------------------------------------------------------------

def test_batched_mode_rejects_active_fault_model():
    with pytest.raises(NotImplementedError):
        ServingCluster(CFG, n_nodes=2, policies=[None] * 2,
                       step_mode="batched", faults="node-churn")


def test_batched_mode_accepts_none_preset():
    cl = ServingCluster(CFG, n_nodes=2, policies=[None] * 2,
                        step_mode="batched", faults="none")
    assert cl.faults is None


def test_batched_loop_rejects_bound_engines():
    from repro_torch.serving.fleet_step import BatchedFleetLoop
    engines = [InferenceEngine(CFG, EngineConfig(),
                               initial_frequency=A6000.f_max)
               for _ in range(2)]
    FaultModel.from_spec("node-churn").bind(engines)
    with pytest.raises(NotImplementedError):
        BatchedFleetLoop([EngineNode(e, None) for e in engines])
