"""Hierarchical power-cap coordination tests: band semantics on the
bandit (inverted bands, bands narrower than the grid step, pruning /
refinement interaction), band clamping on windowed policies, forced
moves billed as DVFS transitions through the event loop, water-filling
allocation properties, the coordinator meeting a cap that uncoordinated
per-node AGFT violates, and the no-cap bit-identity guarantee against
``tests/golden_agft_decisions.json``."""
import dataclasses
import json
import os

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core import AGFTTuner, LinUCBBank
from repro_torch.core.pruning import PruningConfig, PruningFramework
from repro_torch.energy import A6000
from repro_torch.policies import (BandCoordinator, FleetPowerMeter, StaticPolicy,
                            available_policies, full_busy_power_w,
                            get_policy, waterfill)
from repro_torch.serving import (EngineConfig, EngineNode, EventLoop,
                           InferenceEngine, NetworkModel)
from repro_torch.serving.cluster import ServingCluster, route_by_length
from repro_torch.workloads import PROTOTYPES, generate_requests

CFG = get_config("llama3-3b")
GOLDEN = os.path.join(os.path.dirname(__file__),
                      "golden_agft_decisions.json")


def make_engine(hardware=A6000, **kw):
    return InferenceEngine(CFG, EngineConfig(**kw), hardware=hardware,
                           initial_frequency=hardware.f_max)


def trace(n=80, rate=3.0, seed=21, workload="normal"):
    return generate_requests(PROTOTYPES[workload], n, base_rate=rate,
                             seed=seed)


def mixed_trace(n, seed=11, rate=4.0):
    return (generate_requests(PROTOTYPES["long_context"], n // 2,
                              base_rate=rate, seed=seed)
            + generate_requests(PROTOTYPES["normal"], n - n // 2,
                                base_rate=rate, seed=seed + 1))


# ---------------------------------------------------------------------------
# Band semantics on the LinUCB bank
# ---------------------------------------------------------------------------

class TestBankBand:
    FREQS = [210.0 + 90.0 * k for k in range(18)] + [1800.0]

    def test_band_masks_selection_but_keeps_statistics(self):
        bank = LinUCBBank(self.FREQS, dim=3)
        x = np.array([1.0, 0.5, 0.2])
        for f in bank.frequencies:
            bank.arms[f].update(x, -1.0, edp=5.0)
        bank.set_band(900.0, 1200.0)
        assert bank.legal_frequencies() == [930.0, 1020.0, 1110.0, 1200.0]
        assert 900.0 <= bank.select_ucb(x, 0.5) <= 1200.0
        assert 900.0 <= bank.select_greedy(x) <= 1200.0
        assert 900.0 <= bank.select_thompson(x) <= 1200.0
        # arms outside the band keep their stats and come back on widen
        assert bank.arms[210.0].n == 1
        bank.set_band(A6000.f_min, A6000.f_max)
        assert bank.legal_frequencies() == bank.frequencies
        bank.clear_band()
        assert bank.band is None

    def test_untried_sweep_restricted_to_band(self):
        bank = LinUCBBank(self.FREQS, dim=3)
        bank.set_band(600.0, 900.0)
        x = np.zeros(3)
        # lowest LEGAL untried arm first, not the global lowest
        assert bank.select_ucb(x, 0.8) == 660.0

    def test_inverted_band_is_normalized(self):
        tuner = AGFTTuner(A6000)
        tuner.set_band(1500.0, 1200.0)               # f_lo > f_hi
        assert tuner.band == (1200.0, 1500.0)
        legal = tuner.bank.legal_frequencies()
        assert legal and all(1200.0 <= f <= 1500.0 for f in legal)

    def test_band_narrower_than_step_leaves_one_legal_arm(self):
        tuner = AGFTTuner(A6000)                     # 90 MHz initial grid
        tuner.set_band(1000.0, 1001.0)               # contains no arm
        legal = tuner.bank.legal_frequencies()
        assert len(legal) == 1
        assert legal[0] == 1020.0                    # nearest to midpoint
        # and the bandit still selects it
        x = np.zeros(tuner.features.dim)
        assert tuner.bank.select_ucb(x, 0.8) == 1020.0

    def test_band_outside_envelope_clamps(self):
        tuner = AGFTTuner(A6000)
        tuner.set_band(2000.0, 3000.0)
        assert tuner.band == (A6000.f_max, A6000.f_max)
        assert tuner.bank.legal_frequencies() == [A6000.f_max]

    def test_rebuild_reapplies_band(self):
        bank = LinUCBBank(self.FREQS, dim=3)
        bank.set_band(1100.0, 1400.0)
        bank.rebuild([1100.0 + 15.0 * k for k in range(30)],
                     warm_from=1200.0)
        legal = bank.legal_frequencies()
        assert legal and all(1100.0 <= f <= 1400.0 for f in legal)
        assert any(f > 1400.0 for f in bank.frequencies)  # arms exist...
        assert all(f <= 1400.0 for f in legal)            # ...but masked

    def test_pruning_never_orphans_the_band(self):
        bank = LinUCBBank([210.0, 900.0, 1800.0], dim=3)
        bank.set_band(850.0, 950.0)                  # only 900 is legal
        pruner = PruningFramework(PruningConfig(min_arms=1), A6000.f_max)
        pruner._prune(bank, 900.0, "extreme", 1)
        assert 900.0 in bank.arms                    # refused
        pruner._prune(bank, 210.0, "extreme", 1)
        assert 210.0 not in bank.arms                # out-of-band: fine

    def test_refinement_grid_clipped_to_band(self):
        tuner = AGFTTuner(A6000)
        tuner.set_band(1200.0, 1320.0)
        x = np.zeros(tuner.features.dim)
        for f in tuner.bank.frequencies:
            for _ in range(tuner.cfg.refinement.stat_min_samples):
                tuner.bank.arms[f].update(x, -1.0, edp=5.0)
        anchor = tuner.refiner.maybe_refine(tuner.bank, tuner.pruner, x,
                                            tuner.cfg.refinement.interval)
        assert anchor is not None
        assert all(1200.0 <= f <= 1320.0 for f in tuner.bank.frequencies)


# ---------------------------------------------------------------------------
# Band hook on windowed policies
# ---------------------------------------------------------------------------

class TestWindowedPolicyBand:
    def test_static_decision_clamped_into_band(self):
        policy = StaticPolicy(A6000, frequency_mhz=1200.0)
        policy.set_band(600.0, 900.0)
        eng = make_engine()
        eng.submit(trace(40, seed=14))
        eng.drain(policy=policy)
        assert eng.frequency == 900.0

    def test_inverted_band_tolerated(self):
        policy = StaticPolicy(A6000, frequency_mhz=1200.0)
        policy.set_band(900.0, 600.0)
        assert policy.band == (600.0, 900.0)

    def test_ondemand_fmax_jump_respects_band(self):
        policy = get_policy("ondemand")
        policy.set_band(A6000.f_min, 1110.0)
        eng = make_engine()
        eng.submit(trace(60, rate=8.0, seed=9))      # busy -> wants f_max
        eng.drain(policy=policy)
        freqs = [h["freq"] for h in policy.history if h["acted"]]
        assert freqs and max(freqs) <= 1110.0

    def test_oracle_resweeps_inside_band(self):
        policy = get_policy("oracle")
        policy.set_band(A6000.f_min, 900.0)
        eng = make_engine()
        eng.submit(trace(40, seed=15))
        eng.drain(policy=policy)
        assert policy.frequency_mhz <= 900.0
        assert eng.frequency <= 900.0


# ---------------------------------------------------------------------------
# Driver propagation: forced moves are real DVFS transitions
# ---------------------------------------------------------------------------

class _StubCoordinator:
    """Minimal band coordinator: fixed per-node bands every tick."""
    scope = "fleet"
    coordinates_bands = True
    sampling_period_s = 0.8

    def __init__(self, bands, power_cap_w=None):
        self.bands = bands
        self.power_cap_w = power_cap_w

    def initial_bands(self, engines):
        return self.bands

    def act(self, engines, now):
        return None


class TestDriverPropagation:
    def test_band_excluding_current_freq_forces_billed_move(self):
        hw = dataclasses.replace(A6000, dvfs_transition_cost_j=5.0)
        eng = make_engine(hardware=hw)               # starts at f_max
        eng.submit(trace(40, seed=16))
        loop = EventLoop([EngineNode(eng, None)],
                         fleet_policy=_StubCoordinator([(210.0, 1200.0)]))
        loop.run()
        # the very first propagation moved 1800 -> 1200 and billed it
        assert eng.metrics.c.freq_transitions_total >= 1
        assert eng.metrics.c.energy_joules_total >= 5.0
        assert eng.frequency <= 1200.0

    def test_band_reaches_node_policy_set_band(self):
        eng = make_engine()
        eng.submit(trace(40, seed=17))
        tuner = AGFTTuner(A6000)
        loop = EventLoop([EngineNode(eng, tuner)],
                         fleet_policy=_StubCoordinator([(600.0, 1200.0)]))
        loop.run()
        assert tuner.band == (600.0, 1200.0)
        acted = [h["freq"] for h in tuner.history]
        assert acted and all(600.0 <= f <= 1200.0 for f in acted)

    def test_inverted_band_from_coordinator_normalized(self):
        eng = make_engine()
        eng.submit(trace(30, seed=18))
        loop = EventLoop([EngineNode(eng, None)],
                         fleet_policy=_StubCoordinator([(1200.0, 600.0)]))
        loop.run()
        assert eng.frequency <= 1200.0

    def test_cap_metering_accumulates(self):
        eng = make_engine()
        eng.submit(trace(80, rate=8.0, seed=19))
        meter = FleetPowerMeter(A6000, power_cap_w=1.0)   # absurdly low
        loop = EventLoop([EngineNode(eng, None)], fleet_policy=meter)
        loop.run()
        assert loop.metered_s > 0.0
        assert loop.cap_violation_s == pytest.approx(loop.metered_s)
        assert loop.peak_fleet_power_w > 1.0
        assert loop.mean_fleet_power_w > 1.0


# ---------------------------------------------------------------------------
# Band propagation under delayed (routed) arrivals
# ---------------------------------------------------------------------------

class TestBandsUnderDelayedArrivals:
    """PR-4 band propagation composed with the routed-ARRIVAL event path:
    a coordinator's bands reach engines and node policies while every
    request is still traversing the network, and forced moves are billed
    exactly as on the instant-placement path."""

    def test_initial_band_billed_while_requests_in_flight(self):
        hw = dataclasses.replace(A6000, dvfs_transition_cost_j=5.0)
        cl = ServingCluster(CFG, n_nodes=2, hardware=hw,
                            with_tuners=False,
                            fleet_policy=_StubCoordinator(
                                [(210.0, 1200.0)] * 2),
                            network=NetworkModel.from_spec("fixed:30"))
        cl.submit(trace(40, seed=16))
        # bands propagate at loop construction (t=0) — before the first
        # ROUTE event, so every routed request is still in the network
        loop = EventLoop(cl.nodes, fleet_policy=cl.fleet_policy,
                         router=cl._deliveries)
        for eng in cl.engines:
            assert eng.inflight > 0                  # still in flight...
            assert eng.metrics.c.freq_transitions_total == 1   # ...billed
            assert eng.metrics.c.energy_joules_total >= 5.0
            assert eng.frequency == 1200.0
        loop.run()
        assert sum(len(e.finished) for e in cl.engines) == 40
        assert all(e.frequency <= 1200.0 for e in cl.engines)
        assert all(e.inflight == 0 for e in cl.engines)

    def test_band_reaches_tuner_with_arrivals_in_flight(self):
        tuners = [AGFTTuner(A6000), AGFTTuner(A6000)]
        cl = ServingCluster(CFG, n_nodes=2, policies=tuners,
                            fleet_policy=_StubCoordinator(
                                [(600.0, 1200.0)] * 2),
                            network=NetworkModel.from_spec("fixed:25"))
        cl.submit(trace(60, seed=17))
        cl.drain()
        assert sum(len(e.finished) for e in cl.engines) == 60
        for t in tuners:
            assert t.band == (600.0, 1200.0)
            acted = [h["freq"] for h in t.history]
            assert acted and all(600.0 <= f <= 1200.0 for f in acted)

    def test_cap_metering_spans_inflight_gaps(self):
        """The fleet meter must keep metering across windows where every
        node is idle but deliveries are still in flight (the FLEET_TICK
        train may not die before the network drains)."""
        cl = ServingCluster(CFG, n_nodes=2, with_tuners=False,
                            fleet_policy=get_policy("fleet-meter",
                                                    power_cap_w=1.0),
                            network=NetworkModel.from_spec("fixed:500"))
        cl.submit(trace(30, rate=1.0, seed=18))
        cl.drain()
        loop = cl._loop
        assert sum(len(e.finished) for e in cl.engines) == 30
        assert loop.metered_s > 0.0
        assert loop.cap_violation_s <= loop.metered_s
        assert loop.peak_fleet_power_w > 1.0


# ---------------------------------------------------------------------------
# Water-filling
# ---------------------------------------------------------------------------

class TestWaterfill:
    def test_proportional_when_unconstrained(self):
        alloc = waterfill(100.0, [1.0, 3.0], [1e9, 1e9])
        assert alloc == pytest.approx([25.0, 75.0])

    def test_demand_cap_redistributes(self):
        alloc = waterfill(100.0, [1.0, 1.0], [10.0, 1e9])
        assert alloc[0] == pytest.approx(10.0)
        assert alloc[1] == pytest.approx(90.0)

    def test_slack_flows_back_past_demands(self):
        # demands prioritize scarce budget but must not waste slack
        alloc = waterfill(100.0, [1.0, 1.0], [10.0, 20.0])
        assert sum(alloc) == pytest.approx(100.0)
        assert alloc[1] > alloc[0]

    def test_zero_weights_split_evenly(self):
        alloc = waterfill(60.0, [0.0, 0.0, 0.0], [1e9] * 3)
        assert alloc == pytest.approx([20.0, 20.0, 20.0])

    def test_full_busy_power_monotone(self):
        grid = A6000.frequencies()
        powers = [full_busy_power_w(A6000, f) for f in grid]
        assert powers == sorted(powers)
        assert powers[-1] == pytest.approx(
            A6000.p_idle + A6000.p_static_active
            + A6000.p_dyn_compute + A6000.p_dyn_memory)


# ---------------------------------------------------------------------------
# The coordinator end-to-end
# ---------------------------------------------------------------------------

class TestBandCoordinator:
    def test_registry_scopes(self):
        for name in ("hierarchy", "hierarchy-uniform", "fleet-meter"):
            assert name in available_policies(scope="fleet")
            assert name not in available_policies(scope="node")
        p = get_policy("hierarchy", power_cap_w=500.0)
        assert isinstance(p, BandCoordinator)
        assert p.scope == "fleet"
        with pytest.raises(TypeError, match="fleet-scope"):
            p.maybe_act(make_engine())

    def test_uniform_mode_single_frequency_bands(self):
        coord = get_policy("hierarchy-uniform", power_cap_w=800.0)
        bands = coord._compute_bands([1.0] * 4, [None] * 4)
        assert len(set(bands)) == 1
        lo, hi = bands[0]
        assert lo == hi
        assert 4 * full_busy_power_w(A6000, hi) <= 800.0 + 1e-9

    def test_budget_below_floor_maps_to_fmin(self):
        coord = BandCoordinator(A6000, power_cap_w=10.0)
        assert coord._f_for_budget(1.0) == A6000.f_min

    def test_no_cap_produces_no_bands(self):
        coord = BandCoordinator(A6000)               # power_cap_w=None
        eng = make_engine()
        assert coord.initial_bands([eng]) is None
        assert coord.act([eng], 0.8) is None
        assert coord.bands is None

    def test_hierarchy_meets_cap_pernode_violates(self):
        """The acceptance shape at one budget: uncoordinated per-node
        AGFT violates the cap; the hierarchy holds it."""
        def served(fleet_name, cap):
            cl = ServingCluster(
                CFG, n_nodes=4, with_tuners=False,
                policies=["agft"] * 4,
                fleet_policy=get_policy(fleet_name, power_cap_w=cap),
                router=route_by_length)
            cl.submit(mixed_trace(200))
            cl.drain()
            return cl.summary()
        cap = 300.0
        pern = served("fleet-meter", cap)
        hier = served("hierarchy", cap)
        assert pern.cap_violation_s > 0.0
        assert hier.cap_violation_s == 0.0
        assert hier.peak_fleet_power_w <= cap
        assert hier.finished == pern.finished == 200

    def test_load_weighted_bands_differentiate_nodes(self):
        coord = BandCoordinator(A6000, power_cap_w=500.0)
        # hot node (weight 30) vs idle nodes: hotter -> wider budget
        bands = coord._compute_bands([30.0, 0.0, 0.0, 0.0],
                                     [250.0, 26.0, 26.0, 26.0])
        assert bands[0][1] > bands[1][1]


# ---------------------------------------------------------------------------
# No cap => bit-identical decisions (the golden guarantee)
# ---------------------------------------------------------------------------

class TestNoCapGoldenIdentity:
    def test_uncapped_coordinator_keeps_golden_trajectory(self):
        """Attaching an unconfigured hierarchy coordinator (no cap, so no
        bands) must not move a single AGFT decision vs the committed
        golden trajectory."""
        with open(GOLDEN) as f:
            gold = json.load(f)
        tr = gold["trace"]
        tuner = AGFTTuner(A6000)
        cl = ServingCluster(CFG, n_nodes=1, policies=[tuner],
                            fleet_policy=get_policy("hierarchy"))
        cl.submit(generate_requests(PROTOTYPES[tr["workload"]], tr["n"],
                                    base_rate=tr["rate"], seed=tr["seed"]))
        cl.drain()
        assert [h["freq"] for h in tuner.history] == gold["freqs"]
        assert [h["phase"] for h in tuner.history] == gold["phases"]
        assert tuner.round == gold["rounds"]
        eng = cl.engines[0]
        assert eng.metrics.c.energy_joules_total == pytest.approx(
            gold["energy_j"], rel=1e-9)
        assert eng.clock == pytest.approx(gold["clock"], rel=1e-9)
