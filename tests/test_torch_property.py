"""Hypothesis property tests on system invariants.

The whole module is skipped (not errored) when hypothesis is absent —
install the pinned dev set from requirements-dev.txt to run it."""
import numpy as np
import pytest

pytest.importorskip("hypothesis")

from hypothesis import given, settings                       # noqa: E402
from hypothesis import strategies as st                      # noqa: E402

from repro_torch.core.linucb import LinUCBArm, LinUCBBank          # noqa: E402
from repro_torch.core.page_hinkley import PageHinkley              # noqa: E402
from repro_torch.energy import A6000, DVFSModel                    # noqa: E402
from repro_torch.energy.edp import WindowStats                     # noqa: E402
from repro_torch.configs import get_config                         # noqa: E402
from repro_torch.core.features import FeatureExtractor             # noqa: E402
from repro_torch.serving import (EngineConfig, EngineNode, EventLoop,  # noqa: E402
                           InferenceEngine, NetworkConfig, NetworkModel,
                           PagedKVCache)
from repro_torch.serving.cluster import ServingCluster             # noqa: E402
from repro_torch.serving.request import Request                    # noqa: E402
from repro_torch.workloads import PROTOTYPES, generate_requests    # noqa: E402
from repro_torch.workloads.azure_trace import generate_azure_trace  # noqa: E402

floats01 = st.floats(0.0, 1.0, allow_nan=False)


class TestLinUCBProperties:
    @given(st.lists(st.tuples(
        st.lists(st.floats(-1, 1, allow_nan=False, allow_infinity=False),
                 min_size=3, max_size=3),
        st.floats(-5, 5, allow_nan=False)), min_size=1, max_size=60))
    @settings(max_examples=40, deadline=None)
    def test_a_inv_stays_inverse_and_spd(self, updates):
        arm = LinUCBArm(dim=3)
        for x, r in updates:
            arm.update(np.array(x), r)
        np.testing.assert_allclose(arm.A @ arm.A_inv, np.eye(3), atol=1e-6)
        eig = np.linalg.eigvalsh(arm.A)
        assert np.all(eig >= 1.0 - 1e-9)           # ridge floor preserved

    @given(st.lists(st.floats(-3, 0, allow_nan=False), min_size=2,
                    max_size=50))
    @settings(max_examples=40, deadline=None)
    def test_mean_reward_matches_numpy(self, rewards):
        arm = LinUCBArm(dim=2)
        x = np.array([1.0, 0.5])
        for r in rewards:
            arm.update(x, r)
        np.testing.assert_allclose(arm.mean_reward, np.mean(rewards),
                                   rtol=1e-9)

    @given(st.integers(2, 8), st.integers(0, 200))
    @settings(max_examples=20, deadline=None)
    def test_selection_always_within_action_space(self, n_arms, n_updates):
        rng = np.random.default_rng(0)
        freqs = [300.0 * (i + 1) for i in range(n_arms)]
        bank = LinUCBBank(freqs, dim=3)
        for _ in range(n_updates):
            x = rng.uniform(0, 1, 3)
            f = bank.select_ucb(x, 0.5)
            assert f in bank.arms
            bank.arms[f].update(x, -1.0 + 0.1 * rng.normal())
        assert bank.select_greedy(rng.uniform(0, 1, 3)) in bank.arms


class TestKVCacheProperties:
    @given(st.lists(st.tuples(st.integers(1, 2000), st.integers(1, 400),
                              st.integers(0, 20)), min_size=1, max_size=40))
    @settings(max_examples=50, deadline=None)
    def test_block_accounting_invariant(self, reqs):
        kv = PagedKVCache(num_blocks=256, block_size=16)
        live = []
        for prompt, out, tmpl in reqs:
            r = Request(arrival_time=0.0, prompt_len=prompt, output_len=out,
                        template_id=tmpl)
            if kv.try_allocate(r, prompt + out):
                live.append(r)
                kv.register_prefix(r)
            assert kv.check_invariant()
            assert 0 <= kv.free_blocks <= kv.num_blocks
        for r in live:
            kv.free(r)
            assert kv.check_invariant()
        assert kv.free_blocks + len(kv.prefix_blocks) == kv.num_blocks


class TestDetectorProperties:
    @given(st.floats(0.01, 0.2), st.floats(0.5, 5.0))
    @settings(max_examples=20, deadline=None)
    def test_ph_never_alarms_on_constant(self, delta, threshold):
        ph = PageHinkley(delta=delta, threshold=threshold)
        assert not any(ph.update(-1.0) for _ in range(300))


class TestPowerModelProperties:
    @given(st.floats(1e9, 1e15), st.floats(1e6, 1e12),
           st.floats(210.0, 1800.0))
    @settings(max_examples=60, deadline=None)
    def test_time_positive_power_within_envelope(self, flops, mem, f):
        m = DVFSModel(A6000)
        t, p = m.iteration_time_power(flops, mem, f)
        assert t > 0
        assert A6000.p_idle <= p <= (A6000.p_idle + A6000.p_static_active
                                     + A6000.p_dyn_compute
                                     + A6000.p_dyn_memory + 1e-9)

    @given(st.floats(1e9, 1e14), st.floats(1e6, 1e11))
    @settings(max_examples=30, deadline=None)
    def test_latency_monotone_nonincreasing_in_frequency(self, flops, mem):
        m = DVFSModel(A6000)
        ts = [m.iteration_time_power(flops, mem, f)[0]
              for f in (300.0, 900.0, 1500.0, 1800.0)]
        assert all(a >= b - 1e-12 for a, b in zip(ts, ts[1:]))


class TestWorkloadProperties:
    @given(st.sampled_from(sorted(PROTOTYPES)), st.integers(1, 200),
           st.integers(0, 10))
    @settings(max_examples=20, deadline=None)
    def test_generated_requests_within_spec(self, name, n, seed):
        spec = PROTOTYPES[name]
        reqs = generate_requests(spec, n, seed=seed)
        assert len(reqs) == n
        last = 0.0
        for r in reqs:
            assert spec.context_range[0] <= r.prompt_len \
                <= spec.context_range[1]
            assert spec.generation_range[0] <= r.output_len \
                <= spec.generation_range[1]
            assert 0 <= r.template_id < spec.template_pool
            assert r.arrival_time >= last
            last = r.arrival_time

    @given(st.integers(0, 5))
    @settings(max_examples=5, deadline=None)
    def test_azure_trace_context_heavy_dominates(self, seed):
        reqs = generate_azure_trace(1200.0, base_rate=2.0, seed=seed)
        assert len(reqs) > 100
        ctx_heavy = sum(1 for r in reqs if r.prompt_len > 2 * r.output_len)
        assert ctx_heavy / len(reqs) > 0.6       # 2024 mix: context-heavy


class TestEventOrderingProperties:
    """The discrete-event driver must never run an engine backwards in
    time, whatever the trace shape or node count."""

    @given(n_nodes=st.integers(1, 4),
           seed=st.integers(0, 1000),
           rate=st.floats(0.3, 8.0),
           workload=st.sampled_from(["normal", "high_concurrency",
                                     "long_generation"]))
    @settings(max_examples=15, deadline=None)
    def test_clocks_never_decrease(self, n_nodes, seed, rate, workload):
        nodes = []
        clocks = {}

        class Probe:
            """Records the engine clock at every iteration-complete."""
            def __init__(self, idx):
                self.idx = idx

            def maybe_act(self, engine):
                clocks.setdefault(self.idx, []).append(engine.clock)
                return None

        cfg = get_config("llama3-3b")
        for i in range(n_nodes):
            eng = InferenceEngine(cfg, EngineConfig())
            eng.submit(generate_requests(PROTOTYPES[workload], 15,
                                         base_rate=rate, seed=seed + i))
            nodes.append(EngineNode(eng, Probe(i)))
        loop = EventLoop(nodes)
        nows = []
        orig_push = loop._push

        def push_probe(t, kind, node):
            nows.append(loop.now)
            orig_push(t, kind, node)
        loop._push = push_probe
        loop.run()

        assert nows == sorted(nows)                 # virtual time monotone
        for series in clocks.values():              # per-engine monotone
            assert all(a <= b for a, b in zip(series, series[1:]))
        for node in nodes:
            assert not node.engine.has_work         # everything drained


class TestNetworkRoutingProperties:
    """ARRIVAL rescheduling through the router event source must keep
    every clock monotone (no same-node reordering, no time travel),
    deliver every request, and — at zero delay — be byte-identical to
    direct submit."""

    CFG = get_config("llama3-3b")

    def _routed_cluster(self, n_nodes, seed, net, policies=None,
                        n_requests=25, rate=3.0):
        cl = ServingCluster(self.CFG, n_nodes=n_nodes, with_tuners=False,
                            policies=policies, network=net)
        cl.submit(generate_requests(PROTOTYPES["normal"], n_requests,
                                    base_rate=rate, seed=seed))
        return cl

    @given(n_nodes=st.integers(1, 3), seed=st.integers(0, 500),
           delay_ms=st.floats(0.0, 60.0), rate=st.floats(0.5, 6.0))
    @settings(max_examples=12, deadline=None)
    def test_rescheduled_arrivals_never_time_travel(self, n_nodes, seed,
                                                    delay_ms, rate):
        clocks = {}

        class Probe:
            def __init__(self, idx):
                self.idx = idx

            def maybe_act(self, engine):
                clocks.setdefault(self.idx, []).append(engine.clock)
                return None

        net = NetworkModel(NetworkConfig(hop_latency_s=delay_ms * 1e-3 / 2,
                                         router_service_s=1e-4,
                                         distribution="lognormal",
                                         jitter=0.3), seed=seed)
        cl = self._routed_cluster(n_nodes, seed, net,
                                  policies=[Probe(i)
                                            for i in range(n_nodes)],
                                  rate=rate)
        loop = EventLoop(cl.nodes, router=cl._deliveries)
        nows = []
        orig_push = loop._push

        def push_probe(t, kind, node):
            nows.append(loop.now)
            orig_push(t, kind, node)
        loop._push = push_probe
        loop.run()

        assert nows == sorted(nows)              # virtual time monotone
        for series in clocks.values():           # per-node event monotone
            assert all(a <= b for a, b in zip(series, series[1:]))
        fin = [r for e in cl.engines for r in e.finished]
        assert len(fin) == 25                    # every delivery landed
        for r in fin:
            assert r.delivery_time >= r.arrival_time
            # never scheduled before the network handed it over
            assert r.first_scheduled_time >= r.delivery_time - 1e-12
        assert all(e.inflight == 0 for e in cl.engines)
        assert not cl.has_work

    @given(n_nodes=st.integers(1, 3), seed=st.integers(0, 500))
    @settings(max_examples=8, deadline=None)
    def test_zero_delay_network_byte_identical_to_direct(self, n_nodes,
                                                         seed):
        def state(net):
            cl = self._routed_cluster(n_nodes, seed, net,
                                      policies=["agft"] * n_nodes)
            steps = cl.drain()
            return {
                "steps": steps,
                "clocks": [e.clock for e in cl.engines],
                "energies": [e.metrics.c.energy_joules_total
                             for e in cl.engines],
                "finished": [len(e.finished) for e in cl.engines],
                "histories": [[(h["t"], h["freq"], h["phase"])
                               for h in p.history]
                              for p in cl.policies],
            }
        assert state(None) == state(NetworkModel())


class TestFeatureProperties:
    @given(st.floats(0.1, 10), st.floats(0, 1e5), st.floats(0, 1e5),
           st.integers(0, 1000), st.integers(0, 64), st.integers(0, 64),
           floats01, floats01)
    @settings(max_examples=60, deadline=None)
    def test_features_bounded_and_finite(self, dur, e, busy, toks, run,
                                         wait, usage, hit):
        w = WindowStats(duration_s=dur, energy_j=e, busy_s=busy,
                        prefill_tokens=toks, cached_prompt_tokens=0,
                        generation_tokens=toks, iterations=max(toks, 1),
                        requests_running=run, requests_waiting=wait,
                        gpu_cache_usage=usage, cache_hit_rate=hit)
        x = FeatureExtractor()(w)
        assert x.shape == (7,)
        assert np.all(np.isfinite(x))
        assert np.all(x >= 0) and np.all(x <= 1.5)
