"""Routed-arrival + POLICY_TICK event-core tests: NetworkModel pricing
(hop distributions, router FIFO queueing, determinism), the
DeliverySchedule event source, ARRIVAL rescheduling through the event
loop (stale-event supersession, drained-node revival, t_end-cut
resumption), zero-delay byte-identity with direct submit in BOTH policy
scheduling modes, the golden equivalences (iteration-gated == committed
golden through the routed path; pure-tick == the committed tick golden),
and tick-mode semantics on windowed policies."""
import json
import os

import pytest

from repro_torch.configs import get_config
from repro_torch.core import AGFTTuner
from repro_torch.energy import A6000
from repro_torch.policies import StaticPolicy, get_policy
from repro_torch.serving import (EngineConfig, EngineNode, EventKind, EventLoop,
                           InferenceEngine, NetworkConfig, NetworkModel,
                           Request)
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.network import PRESETS, DeliverySchedule
from repro_torch.workloads import PROTOTYPES, generate_requests

CFG = get_config("llama3-3b")
HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden_agft_decisions.json")
GOLDEN_TICK = os.path.join(HERE, "golden_agft_decisions_tick.json")


def make_engine(**kw):
    return InferenceEngine(CFG, EngineConfig(**kw),
                           initial_frequency=A6000.f_max)


def trace(n=80, rate=3.0, seed=21, workload="normal"):
    return generate_requests(PROTOTYPES[workload], n, base_rate=rate,
                             seed=seed)


# ---------------------------------------------------------------------------
# NetworkModel pricing
# ---------------------------------------------------------------------------

class TestNetworkModel:
    def test_zero_model_prices_arrival_exactly(self):
        net = NetworkModel()
        for t in (0.0, 0.1, 3.7, 1234.5678901234):
            assert net.delivery_time(t) == t       # bit-exact, no detour

    def test_constant_hops_add_up(self):
        net = NetworkModel(NetworkConfig(hop_latency_s=5e-3,
                                         router_service_s=1e-3))
        # sparse arrivals: no queueing, so delay = 2 hops + 1 service
        assert net.delivery_time(10.0) == pytest.approx(10.0 + 11e-3)
        assert net.delivery_time(20.0) == pytest.approx(20.0 + 11e-3)

    def test_router_fifo_queues_bursts(self):
        net = NetworkModel(NetworkConfig(router_service_s=2e-3))
        # 4 simultaneous arrivals drain through one dispatch pipe
        ts = [net.delivery_time(1.0) for _ in range(4)]
        assert ts == pytest.approx([1.002, 1.004, 1.006, 1.008])
        # pipe goes idle before a later arrival: no residual queueing
        assert net.delivery_time(5.0) == pytest.approx(5.002)

    def test_seeded_streams_reproduce(self):
        cfg = NetworkConfig(hop_latency_s=10e-3, distribution="lognormal",
                            jitter=0.5)
        a = [NetworkModel(cfg, seed=3).delivery_time(t)
             for t in (0.0, 1.0, 2.0)]
        b = [NetworkModel(cfg, seed=3).delivery_time(t)
             for t in (0.0, 1.0, 2.0)]
        c = [NetworkModel(cfg, seed=4).delivery_time(t)
             for t in (0.0, 1.0, 2.0)]
        assert a == b
        assert a != c

    def test_uniform_jitter_bounded(self):
        net = NetworkModel(NetworkConfig(hop_latency_s=10e-3,
                                         distribution="uniform",
                                         jitter=0.5))
        for _ in range(50):
            d = net.delivery_time(0.0)
            assert 2 * 5e-3 <= d <= 2 * 15e-3

    def test_lognormal_mean_calibrated(self):
        net = NetworkModel(NetworkConfig(hop_latency_s=10e-3,
                                         distribution="lognormal",
                                         jitter=0.3), seed=1)
        delays = [net.delivery_time(0.0) for _ in range(400)]
        assert all(d > 0 for d in delays)
        mean = sum(delays) / len(delays)
        assert mean == pytest.approx(20e-3, rel=0.15)

    def test_delays_never_negative(self):
        for name in PRESETS:
            net = NetworkModel(PRESETS[name], seed=9)
            for t in (0.0, 0.5, 1.0):
                assert net.delivery_time(t) >= t

    def test_from_spec_presets_and_fixed(self):
        assert NetworkModel.from_spec("wan").config is PRESETS["wan"]
        fixed = NetworkModel.from_spec("fixed:30")
        assert fixed.delivery_time(2.0) == pytest.approx(2.030)
        with pytest.raises(ValueError, match="unknown network spec"):
            NetworkModel.from_spec("interplanetary")
        with pytest.raises(ValueError):
            NetworkModel.from_spec("fixed:-1")

    def test_invalid_config_rejected(self):
        with pytest.raises(ValueError, match="distribution"):
            NetworkModel(NetworkConfig(distribution="cauchy"))
        with pytest.raises(ValueError, match=">= 0"):
            NetworkModel(NetworkConfig(hop_latency_s=-1.0))

    def test_override_kwargs(self):
        net = NetworkModel(PRESETS["wan"], hop_latency_s=1e-3, jitter=0.0)
        assert net.config.hop_latency_s == 1e-3
        assert net.config.router_service_s == PRESETS["wan"].router_service_s


class TestDeliverySchedule:
    def test_pop_due_time_then_fifo_order(self):
        sched = DeliverySchedule()
        sched.push(2.0, 1, "b")
        sched.push(1.0, 0, "a")
        sched.push(2.0, 0, "c")        # same time as "b": FIFO after it
        assert sched.next_time() == 1.0
        assert sched.pop_due(1.5) == [(0, "a")]
        assert sched.pop_due(1.6) == []
        assert sched.pop_due(2.0) == [(1, "b"), (0, "c")]
        assert len(sched) == 0
        assert sched.next_time() is None

    def test_first_time_per_node(self):
        sched = DeliverySchedule()
        sched.push(3.0, 0, "x")
        sched.push(1.0, 1, "y")
        sched.push(2.0, 0, "z")
        assert sched.first_time_per_node() == {0: 2.0, 1: 1.0}


# ---------------------------------------------------------------------------
# Zero-delay network == direct submit, byte for byte (both tick modes)
# ---------------------------------------------------------------------------

def _cluster_state(cl):
    return {
        "finished": [len(e.finished) for e in cl.engines],
        "clocks": [e.clock for e in cl.engines],
        "energies": [e.metrics.c.energy_joules_total for e in cl.engines],
        "iterations": [e.metrics.c.iterations_total for e in cl.engines],
        "frequencies": [e.frequency for e in cl.engines],
        "histories": [[(h["t"], h["freq"], h["phase"]) for h in p.history]
                      for p in cl.policies if p is not None],
    }


class TestZeroDelayEquivalence:
    @pytest.mark.parametrize("mode", ["iteration", "tick"])
    @pytest.mark.parametrize("n_nodes", [1, 3])
    def test_zero_delay_byte_identical_to_direct(self, mode, n_nodes):
        def serve(net):
            cl = ServingCluster(CFG, n_nodes=n_nodes,
                                policies=["agft"] * n_nodes,
                                network=net, policy_tick_mode=mode)
            cl.submit(trace(90, seed=33))
            steps = cl.drain()
            return steps, _cluster_state(cl)
        s_direct, direct = serve(None)
        s_net, routed = serve(NetworkModel())
        assert direct == routed
        assert s_direct == s_net

    def test_zero_delay_requests_carry_delivery_times(self):
        cl = ServingCluster(CFG, n_nodes=2, with_tuners=False,
                            network=NetworkModel())
        cl.submit(trace(30, seed=8))
        cl.drain()
        fin = [r for e in cl.engines for r in e.finished]
        assert len(fin) == 30
        assert all(r.delivery_time == r.arrival_time for r in fin)
        assert all(r.net_delay == 0.0 for r in fin)
        s = cl.summary()
        assert s.mean_net_delay_s == 0.0
        assert s.max_net_delay_s == 0.0


# ---------------------------------------------------------------------------
# Delayed arrivals through the event loop
# ---------------------------------------------------------------------------

class TestDelayedArrivals:
    def _serve(self, net, n=60, seed=12, **kw):
        cl = ServingCluster(CFG, n_nodes=2, with_tuners=False,
                            network=net, **kw)
        cl.submit(trace(n, seed=seed))
        cl.drain()
        return cl

    def test_delay_completes_and_never_time_travels(self):
        cl = self._serve(NetworkModel.from_spec("wan", seed=5))
        fin = [r for e in cl.engines for r in e.finished]
        assert len(fin) == 60
        for r in fin:
            assert r.delivery_time > r.arrival_time
            # a request is never scheduled before the network delivered it
            assert r.first_scheduled_time >= r.delivery_time - 1e-12

    def test_delay_inflates_ttft_not_finish_count(self):
        direct = self._serve(None)
        routed = self._serve(NetworkModel.from_spec("fixed:40"))
        sd, sr = direct.summary(), routed.summary()
        assert sr.finished == sd.finished == 60
        assert sr.mean_net_delay_s == pytest.approx(0.040)
        # the 40 ms spent in the network lands in first-token latency
        assert sr.mean_ttft_s > sd.mean_ttft_s + 0.030

    def test_inflight_counts_drain_to_zero(self):
        cl = self._serve(NetworkModel.from_spec("wan"))
        assert all(e.inflight == 0 for e in cl.engines)
        assert len(cl._deliveries) == 0
        assert not cl.has_work

    def test_route_events_counted(self):
        cl = self._serve(NetworkModel.from_spec("wan"))
        counts = cl._loop.counts
        assert counts[EventKind.ROUTE] > 0
        assert counts[EventKind.ARRIVAL] + counts[EventKind.ITERATION] \
            == cl._loop.steps

    def test_waiting_telemetry_includes_inflight(self):
        eng = make_engine()
        eng.inflight = 7
        eng.submit(trace(5, seed=2))
        for _ in range(3):
            eng.step()
        assert eng.metrics.c.requests_waiting >= 7
        assert eng.num_pending >= 7


class TestArrivalRescheduling:
    def _delivery(self, t, node, prompt=64, out=16, arrival=0.0):
        sched = DeliverySchedule()
        sched.push(t, node, Request(arrival_time=arrival, prompt_len=prompt,
                                    output_len=out))
        return sched

    def test_delivery_revives_drained_node(self):
        eng = make_engine()                      # no initial work at all
        sched = self._delivery(1.5, 0)
        loop = EventLoop([EngineNode(eng, None)], router=sched)
        steps = loop.run()
        assert steps > 0
        assert len(eng.finished) == 1
        assert eng.finished[0].first_scheduled_time >= 1.5
        assert loop.counts[EventKind.ROUTE] == 1

    def test_early_delivery_supersedes_scheduled_arrival(self):
        eng = make_engine()
        late = Request(arrival_time=10.0, prompt_len=64, output_len=8)
        eng.submit([late])                       # ARRIVAL event lands at 10
        sched = self._delivery(2.0, 0)           # ...but this lands at 2
        loop = EventLoop([EngineNode(eng, None)], router=sched)
        loop.run()
        assert len(eng.finished) == 2
        delivered = next(r for r in eng.finished if r is not late)
        assert delivered.first_scheduled_time < 10.0
        assert delivered.finish_time < late.first_scheduled_time
        # the stale ARRIVAL@10 was orphaned, not double-fired
        assert loop.counts[EventKind.ARRIVAL] >= 1

    def test_t_end_cut_resumes_consistently(self):
        net = NetworkModel.from_spec("fixed:20")
        cl = ServingCluster(CFG, n_nodes=2, with_tuners=False, network=net)
        cl.submit(trace(40, rate=1.0, seed=4))
        loop = EventLoop(cl.nodes, router=cl._deliveries, t_end=5.0)
        loop.run()
        fin_early = sum(len(e.finished) for e in cl.engines)
        assert fin_early < 40                    # the horizon cut the run
        assert cl.has_work                       # deliveries/work remain
        cl.drain()                               # fresh loop resumes
        assert sum(len(e.finished) for e in cl.engines) == 40
        assert all(e.inflight == 0 for e in cl.engines)

    def test_fleet_tick_survives_all_nodes_idle_with_inflight(self):
        """The fleet policy must keep ticking while every node is
        momentarily drained but deliveries are still in flight."""
        eng = make_engine()
        sched = DeliverySchedule()
        for k in range(3):
            sched.push(2.0 + 2.0 * k, 0,
                       Request(arrival_time=0.0, prompt_len=32,
                               output_len=8))
        meter = get_policy("fleet-meter", power_cap_w=1.0)
        loop = EventLoop([EngineNode(eng, None)], fleet_policy=meter,
                         router=sched)
        loop.run()
        assert len(eng.finished) == 3
        assert loop.counts[EventKind.FLEET_TICK] > 3
        assert loop.metered_s > 0.0


# ---------------------------------------------------------------------------
# Golden equivalence: the acceptance configuration
# ---------------------------------------------------------------------------

class TestGoldenEquivalence:
    def _golden_trace(self, gold):
        tr = gold["trace"]
        return generate_requests(PROTOTYPES[tr["workload"]], tr["n"],
                                 base_rate=tr["rate"], seed=tr["seed"])

    def _assert_matches(self, gold, tuner, eng):
        assert [h["freq"] for h in tuner.history] == gold["freqs"]
        assert [h["phase"] for h in tuner.history] == gold["phases"]
        assert tuner.round == gold["rounds"]
        assert eng.metrics.c.energy_joules_total == pytest.approx(
            gold["energy_j"], rel=1e-12)
        assert eng.clock == pytest.approx(gold["clock"], rel=1e-12)

    def test_zero_delay_iteration_gated_reproduces_golden(self):
        """The PR's acceptance bit: routing through a zero-delay network
        with iteration-gated policies must not move one AGFT decision vs
        the committed golden trajectory."""
        with open(GOLDEN) as f:
            gold = json.load(f)
        tuner = AGFTTuner(A6000)
        cl = ServingCluster(CFG, n_nodes=1, policies=[tuner],
                            network=NetworkModel(),
                            policy_tick_mode="iteration")
        cl.submit(self._golden_trace(gold))
        cl.drain()
        self._assert_matches(gold, tuner, cl.engines[0])

    def test_pure_tick_reproduces_tick_golden(self):
        with open(GOLDEN_TICK) as f:
            gold = json.load(f)
        eng = make_engine()
        eng.submit(self._golden_trace(gold))
        tuner = AGFTTuner(A6000)
        EventLoop([EngineNode(eng, tuner)], policy_tick_mode="tick").run()
        self._assert_matches(gold, tuner, eng)

    def test_tick_golden_through_zero_delay_cluster(self):
        """Pure-tick + zero-delay network lands on the same committed
        tick trajectory — the two event sources compose without moving
        decisions."""
        with open(GOLDEN_TICK) as f:
            gold = json.load(f)
        tuner = AGFTTuner(A6000)
        cl = ServingCluster(CFG, n_nodes=1, policies=[tuner],
                            network=NetworkModel(),
                            policy_tick_mode="tick")
        cl.submit(self._golden_trace(gold))
        cl.drain()
        self._assert_matches(gold, tuner, cl.engines[0])

    def test_the_two_goldens_differ(self):
        """Decoupling decision boundaries from iteration boundaries must
        actually change the trajectory — otherwise the second golden
        pins nothing."""
        with open(GOLDEN) as f:
            gold = json.load(f)
        with open(GOLDEN_TICK) as f:
            tick = json.load(f)
        assert gold["freqs"] != tick["freqs"]


# ---------------------------------------------------------------------------
# POLICY_TICK semantics
# ---------------------------------------------------------------------------

class TestPolicyTickMode:
    def test_invalid_mode_rejected(self):
        with pytest.raises(ValueError, match="policy_tick_mode"):
            EventLoop([EngineNode(make_engine(), None)],
                      policy_tick_mode="hourly")
        with pytest.raises(ValueError, match="policy_tick_mode"):
            ServingCluster(CFG, n_nodes=2, policy_tick_mode="hourly")

    def test_tick_mode_windows_cut_on_wallclock_cadence(self):
        policy = get_policy("observer")          # records, never actuates
        eng = make_engine()
        eng.submit(trace(60, seed=6))
        EventLoop([EngineNode(eng, policy)], policy_tick_mode="tick").run()
        ts = [h["t"] for h in policy.history]
        assert len(ts) > 3
        gaps = [b - a for a, b in zip(ts, ts[1:])]
        # exact wall-clock periods, not iteration-boundary overshoots
        assert all(g == pytest.approx(0.8) for g in gaps)

    def test_iteration_mode_windows_land_on_iteration_boundaries(self):
        policy = get_policy("observer")
        eng = make_engine()
        eng.submit(trace(60, seed=6))
        eng.drain(policy=policy)
        gaps = [b - a for a, b in zip(
            (h["t"] for h in policy.history),
            [h["t"] for h in policy.history][1:])]
        # the engine clock gates: windows stretch past the period
        assert any(g > 0.8 + 1e-6 for g in gaps)

    def test_windowed_policy_tick_respects_band_and_envelope(self):
        policy = StaticPolicy(A6000, frequency_mhz=1200.0)
        policy.set_band(600.0, 900.0)
        eng = make_engine()
        eng.submit(trace(40, seed=14))
        EventLoop([EngineNode(eng, policy)], policy_tick_mode="tick").run()
        assert eng.frequency == 900.0

    def test_duck_typed_policy_falls_back_to_maybe_act(self):
        calls = []

        class Minimal:
            def maybe_act(self, engine):
                calls.append(engine.clock)
                return None

        eng = make_engine()
        eng.submit(trace(30, seed=7))
        EventLoop([EngineNode(eng, Minimal())],
                  policy_tick_mode="tick").run()
        assert calls                             # ticked via the fallback
        assert len(eng.finished) == 30

    def test_tick_counts_exposed(self):
        eng = make_engine()
        eng.submit(trace(40, seed=9))
        loop = EventLoop([EngineNode(eng, get_policy("observer"))],
                         policy_tick_mode="tick")
        loop.run()
        assert loop.counts[EventKind.POLICY_TICK] > 0
        assert loop.counts[EventKind.POLICY_TICK] \
            >= len(loop.nodes[0].policy.history)

    def test_tick_mode_with_heterogeneous_periods(self):
        nodes = []
        for period in (0.4, 1.6):
            eng = make_engine()
            eng.submit(trace(40, seed=10))
            nodes.append(EngineNode(
                eng, get_policy("observer", sampling_period_s=period)))
        EventLoop(nodes, policy_tick_mode="tick").run()
        h_fast = nodes[0].policy.history
        h_slow = nodes[1].policy.history
        assert len(h_fast) > len(h_slow)

    def test_tick_train_restarts_with_node_revival(self):
        """A bare DeliverySchedule user (no ServingCluster inflight
        bookkeeping): the node drains between widely-spaced deliveries,
        killing its tick train — the reviving ROUTE must restart it, or
        later requests would be served with zero policy decisions."""
        eng = make_engine()
        sched = DeliverySchedule()
        sched.push(0.0, 0, Request(arrival_time=0.0, prompt_len=64,
                                   output_len=8))
        sched.push(30.0, 0, Request(arrival_time=30.0, prompt_len=64,
                                    output_len=8))
        policy = get_policy("observer")
        loop = EventLoop([EngineNode(eng, policy)], router=sched,
                         policy_tick_mode="tick")
        loop.run()
        assert len(eng.finished) == 2
        ts = [h["t"] for h in policy.history]
        # decisions exist on BOTH sides of the drained 30 s gap
        assert any(t < 10.0 for t in ts)
        assert any(t >= 30.0 for t in ts)
        # ...but the train did die in between instead of ticking idly
        assert not any(10.0 < t < 30.0 for t in ts)

    def test_cluster_threads_tick_mode_and_network(self):
        cl = ServingCluster(CFG, n_nodes=2, policies=["agft", "slo"],
                            network="wan", policy_tick_mode="tick")
        cl.submit(trace(60, seed=11))
        cl.drain()
        s = cl.summary()
        assert s.finished == 60
        assert s.mean_net_delay_s > 0.0
        assert all(len(p.history) > 0 for p in cl.policies)
