"""Serving-substrate tests: scheduler/KV-cache invariants, engine
accounting, energy model monotonicities, and the AGFT closed loop
end-to-end on the simulated engine. (The hypothesis-based KV property
test lives in test_property.py so this module runs without hypothesis.)"""
import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core import AGFTTuner
from repro_torch.energy import A6000, DVFSModel, active_param_count, param_count
from repro_torch.energy.edp import diff_snapshots
from repro_torch.serving import (EngineConfig, InferenceEngine, PagedKVCache,
                           Request)
from repro_torch.workloads import PROTOTYPES, generate_azure_trace, \
    generate_requests

CFG = get_config("llama3-3b")


# ---------------------------------------------------------------------------
# KV cache properties
# ---------------------------------------------------------------------------

class TestPagedKVCache:
    def test_prefix_cache_hits_on_repeat_template(self):
        kv = PagedKVCache(num_blocks=512, block_size=16)
        r1 = Request(arrival_time=0, prompt_len=320, output_len=10,
                     template_id=7)
        assert kv.try_allocate(r1, 330)
        assert r1.cached_tokens == 0
        kv.register_prefix(r1)
        kv.free(r1)
        r2 = Request(arrival_time=1, prompt_len=320, output_len=10,
                     template_id=7)
        assert kv.try_allocate(r2, 330)
        assert r2.cached_tokens > 0                   # prefix reused
        assert kv.stats.hit_rate > 0

    def test_no_hits_across_templates(self):
        kv = PagedKVCache(num_blocks=512, block_size=16)
        r1 = Request(arrival_time=0, prompt_len=320, output_len=10,
                     template_id=1)
        kv.try_allocate(r1, 330)
        kv.register_prefix(r1)
        kv.free(r1)
        r2 = Request(arrival_time=1, prompt_len=320, output_len=10,
                     template_id=2)
        kv.try_allocate(r2, 330)
        assert r2.cached_tokens == 0

    def test_allocation_fails_when_full_then_recovers(self):
        kv = PagedKVCache(num_blocks=8, block_size=16,
                          enable_prefix_cache=False)
        r1 = Request(arrival_time=0, prompt_len=100, output_len=28)
        assert kv.try_allocate(r1, 128)               # all 8 blocks
        r2 = Request(arrival_time=0, prompt_len=100, output_len=28)
        assert not kv.try_allocate(r2, 128)
        kv.free(r1)
        assert kv.try_allocate(r2, 128)


# ---------------------------------------------------------------------------
# Scheduler / engine behaviour
# ---------------------------------------------------------------------------

class TestEngine:
    def _engine(self, **kw):
        return InferenceEngine(CFG, EngineConfig(**kw),
                               initial_frequency=A6000.f_max)

    def test_all_requests_finish_with_correct_tokens(self):
        eng = self._engine()
        reqs = generate_requests(PROTOTYPES["normal"], 50, base_rate=5.0,
                                 seed=0)
        eng.submit(reqs)
        eng.drain()
        assert len(eng.finished) == 50
        for r in eng.finished:
            assert r.generated == r.output_len
            assert r.prefilled == r.prompt_len
            assert r.finish_time >= r.arrival_time
            assert r.ttft is not None and r.ttft > 0

    def test_continuous_batching_interleaves_prefill_and_decode(self):
        eng = self._engine(prefill_chunk=128, max_batched_tokens=512)
        reqs = generate_requests(PROTOTYPES["normal"], 40, base_rate=20.0,
                                 seed=1)
        eng.submit(reqs)
        mixed = 0
        while eng.has_work:
            eng._ingest_arrivals()
            plan = eng.sched.schedule(eng.clock)
            if plan.prefill and plan.decode:
                mixed += 1
            if plan.empty:
                eng.step()
                continue
            dt, energy, power = eng.backend.execute(plan, eng.frequency)
            eng.clock += dt
            fin = eng.sched.complete_iteration(plan, eng.clock)
            eng.finished.extend(fin)
            eng.metrics.c.energy_joules_total += energy
            eng.metrics.c.busy_seconds_total += dt
            eng.metrics.c.generation_tokens_total += plan.decode_seqs
            eng.metrics.c.iterations_total += 1
        assert mixed > 0                     # prefill+decode share iterations

    def test_token_budget_respected(self):
        eng = self._engine(max_batched_tokens=256, prefill_chunk=128)
        eng.submit(generate_requests(PROTOTYPES["long_context"], 20,
                                     base_rate=50.0, seed=2))
        while eng.has_work:
            eng._ingest_arrivals()
            plan = eng.sched.schedule(eng.clock)
            assert plan.total_tokens <= 256
            if plan.empty:
                eng.step()
                continue
            dt, e, p = eng.backend.execute(plan, eng.frequency)
            eng.clock += dt
            eng.finished.extend(eng.sched.complete_iteration(plan, eng.clock))

    def test_energy_monotone_in_frequency_at_fixed_work(self):
        energies = []
        for f in (600.0, 1200.0, 1800.0):
            eng = self._engine()
            eng.set_frequency(f)
            eng.submit(generate_requests(PROTOTYPES["normal"], 30,
                                         base_rate=100.0, seed=3))
            eng.drain()
            energies.append(eng.metrics.c.busy_seconds_total and
                            eng.metrics.c.energy_joules_total)
        assert energies[0] < energies[2]      # downclocking saves energy

    def test_latency_monotone_decreasing_in_frequency(self):
        tpots = []
        for f in (400.0, 1800.0):
            eng = self._engine()
            eng.set_frequency(f)
            eng.submit(generate_requests(PROTOTYPES["normal"], 30,
                                         base_rate=100.0, seed=3))
            eng.drain()
            tpots.append(np.mean([r.tpot for r in eng.finished
                                  if r.tpot is not None]))
        assert tpots[0] > tpots[1]

    def test_metrics_snapshot_diff(self):
        eng = self._engine()
        eng.submit(generate_requests(PROTOTYPES["normal"], 20,
                                     base_rate=10.0, seed=4))
        s0 = eng.metrics.snapshot()
        t0 = eng.clock
        for _ in range(50):
            if not eng.has_work:
                break
            eng.step()
        w = diff_snapshots(s0, eng.metrics.snapshot(), eng.clock - t0)
        assert w.energy_j > 0
        assert w.generation_tokens >= 0
        assert 0 <= w.cache_hit_rate <= 1
        assert w.edp >= 0

    def test_preemption_under_kv_pressure(self):
        eng = self._engine(num_kv_blocks=96, max_num_seqs=32)
        eng.submit(generate_requests(PROTOTYPES["high_concurrency"], 60,
                                     base_rate=50.0, seed=5))
        eng.drain()
        assert len(eng.finished) == 60        # everything still completes


# ---------------------------------------------------------------------------
# Energy / power model
# ---------------------------------------------------------------------------

class TestPowerModel:
    def test_power_increases_with_frequency(self):
        m = DVFSModel(A6000)
        _, p_low = m.iteration_time_power(1e12, 1e9, 600.0)
        _, p_high = m.iteration_time_power(1e12, 1e9, 1800.0)
        assert p_high > p_low

    def test_compute_bound_latency_scales_inverse_freq(self):
        m = DVFSModel(A6000)
        t1, _ = m.iteration_time_power(1e13, 1e6, 700.0)
        t2, _ = m.iteration_time_power(1e13, 1e6, 1400.0)
        assert t1 / t2 == pytest.approx(2.0, rel=0.05)

    def test_memory_bound_latency_flat_above_knee(self):
        m = DVFSModel(A6000)
        f_knee = A6000.bw_knee * A6000.f_max
        t1, _ = m.iteration_time_power(1e6, 1e10, f_knee + 100)
        t2, _ = m.iteration_time_power(1e6, 1e10, A6000.f_max)
        assert t1 == pytest.approx(t2, rel=0.02)

    def test_edp_u_shape_for_memory_bound_work(self):
        """EDP(f) = P t^2 must have an interior minimum for decode-like
        (memory-bound) work — the core phenomenon behind the paper."""
        m = DVFSModel(A6000)
        freqs = np.arange(210, 1801, 15)
        edp = []
        for f in freqs:
            t, p = m.iteration_time_power(5e10, 1.2e10, float(f))
            edp.append(p * t * t)
        i = int(np.argmin(edp))
        assert 0 < i < len(freqs) - 1, "optimum must be interior"
        assert 900 <= freqs[i] <= 1500

    def test_param_counts_scale(self):
        n = param_count(CFG)
        assert 2.5e9 < n < 4.5e9              # llama-3-3b class
        moe = get_config("llama4-scout-17b-a16e")
        assert active_param_count(moe) < 0.35 * param_count(moe)


# ---------------------------------------------------------------------------
# AGFT end-to-end on the simulated engine
# ---------------------------------------------------------------------------

class TestAGFTEndToEnd:
    def _run(self, tuner, n=400, rate=3.0, seed=7, workload="normal"):
        eng = InferenceEngine(CFG, EngineConfig(),
                              initial_frequency=A6000.f_max)
        eng.submit(generate_requests(PROTOTYPES[workload], n,
                                     base_rate=rate, seed=seed))
        eng.drain(policy=tuner)
        return eng

    def test_agft_saves_energy_and_improves_edp(self):
        base = self._run(None)
        tuner = AGFTTuner(A6000)
        agft = self._run(tuner)
        eb = base.metrics.c.energy_joules_total
        ea = agft.metrics.c.energy_joules_total
        tpb = np.mean([r.tpot for r in base.finished if r.tpot is not None])
        tpa = np.mean([r.tpot for r in agft.finished if r.tpot is not None])
        assert ea < 0.8 * eb                          # >=20% energy saving
        assert ea * tpa < eb * tpb                    # EDP strictly better
        assert len(agft.finished) == len(base.finished)

    def test_agft_converges_and_exploits(self):
        tuner = AGFTTuner(A6000)
        self._run(tuner, n=800)
        post = [h for h in tuner.history if h["converged"]]
        assert len(post) > 0.3 * len(tuner.history)
        assert any(h["phase"] == "exploit" for h in tuner.history)

    def test_pruning_shrinks_action_space(self):
        tuner = AGFTTuner(A6000)
        self._run(tuner, n=600)
        assert len(tuner.pruner.permanently_pruned) > 0
        # pruned frequencies never re-enter the action space
        assert not (set(tuner.bank.arms)
                    & tuner.pruner.permanently_pruned)

    def test_privacy_boundary_features_only(self):
        """The tuner's contexts must be derivable from aggregate metrics
        alone: 7 dims, no per-request fields."""
        tuner = AGFTTuner(A6000)
        self._run(tuner, n=200)
        assert tuner.prev_context.shape == (7,)

    def test_adapts_to_azure_nonstationary_trace(self):
        eng = InferenceEngine(CFG, EngineConfig(),
                              initial_frequency=A6000.f_max)
        eng.submit(generate_azure_trace(600.0, base_rate=2.0, seed=8))
        tuner = AGFTTuner(A6000)
        eng.drain(policy=tuner)
        base = InferenceEngine(CFG, EngineConfig(),
                               initial_frequency=A6000.f_max)
        base.submit(generate_azure_trace(600.0, base_rate=2.0, seed=8))
        base.drain()
        assert (eng.metrics.c.energy_joules_total
                < 0.9 * base.metrics.c.energy_joules_total)
