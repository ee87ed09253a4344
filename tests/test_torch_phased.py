"""Phase-disaggregated DVFS: per-phase pricing, transition billing, the
2-D tuner stack (pair-keyed banks, cascade dominance, product refinement),
the greenllm-rule comparator, the scheduler's admission-cap knob, and the
guards that keep 1-D paths byte-identical and batched mode honest."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# the goldens rendered through the port (tests/test_torch_golden.py)
import test_torch_golden as generate_golden  # noqa: E402

from repro_torch.configs import get_config
from repro_torch.core import AGFTConfig, LinUCBBank, PruningConfig, \
    PruningFramework
from repro_torch.core.refinement import MixedMaturityRefinement, RefinementConfig
from repro_torch.core.tuner2d import AGFT2DTuner
from repro_torch.energy import A6000, A6000_MEASURED
from repro_torch.energy.phases import phase_optimal_frequencies
from repro_torch.policies import get_policy
from repro_torch.serving import EngineConfig, InferenceEngine
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.engine import SimBackend
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import BatchPlan
from repro_torch.workloads import PROTOTYPES, generate_requests

CFG = get_config("llama3-3b")


def _mixed_plan():
    pf = Request(arrival_time=0.0, prompt_len=600, output_len=50)
    pf.prefilled = 128
    d1 = Request(arrival_time=0.0, prompt_len=300, output_len=50)
    d1.prefilled, d1.generated = 300, 10
    d2 = Request(arrival_time=0.0, prompt_len=200, output_len=80)
    d2.prefilled, d2.generated = 200, 40
    return BatchPlan(prefill=[(pf, 256)], decode=[d1, d2])


class TestPhasedPricing:
    def test_mixed_iteration_is_sum_of_per_phase_costs(self):
        """execute_phased prices the same work split as execute, each half
        at its own clock (incl. the shared-weight-read subtraction)."""
        be = SimBackend(CFG, A6000)
        plan = _mixed_plan()
        f_pf, f_de = 1395.0, 1170.0
        t_pf, e_pf, t_de, e_de = be.execute_phased(plan, f_pf, f_de)

        cost = be.cost
        (r, n), = plan.prefill
        fl1, m1 = cost.iteration_cost(prefill_tokens=n, decode_seqs=0,
                                      avg_context=r.prefilled + n / 2)
        t1, p1 = be.dvfs.iteration_time_power(fl1, m1, f_pf)
        ctx = sum(q.prefilled + q.generated for q in plan.decode)
        fl2, m2 = cost.iteration_cost(prefill_tokens=0, decode_seqs=2,
                                      avg_context=ctx / 2)
        m2 = max(m2 - be._shared_weight_bytes, 0.0)
        t2, p2 = be.dvfs.iteration_time_power(fl2, m2, f_de)

        assert (t_pf, e_pf) == (t1, p1 * t1)
        assert (t_de, e_de) == (t2, p2 * t2)

    def test_single_phase_half_matches_1d_execute(self):
        """A decode-only plan priced phased at (anything, f) is exactly
        the 1-D execute at f — no phantom prefill half."""
        be = SimBackend(CFG, A6000)
        plan = BatchPlan(prefill=[], decode=_mixed_plan().decode)
        t, e, p = be.execute(plan, 1200.0)
        t_pf, e_pf, t_de, e_de = be.execute_phased(plan, 1800.0, 1200.0)
        assert (t_pf, e_pf) == (0.0, 0.0)
        assert (t_de, e_de) == (t, e)

    def test_phase_optima_split_compute_vs_bandwidth(self):
        """Prefill (compute-bound) wants a faster clock than decode
        (bandwidth-bound) — the headroom the 2-D surface exploits."""
        f_pf, f_de = phase_optimal_frequencies(A6000, CFG)
        assert f_pf > f_de
        lo, hi = 1300.0, 1500.0
        b_pf, b_de = phase_optimal_frequencies(A6000, CFG, band=(lo, hi))
        assert lo <= b_pf <= hi and lo <= b_de <= hi


class TestPhasedEngine:
    def _engine(self, hw=A6000):
        eng = InferenceEngine(CFG, EngineConfig(), hardware=hw,
                              initial_frequency=hw.f_max)
        eng.submit(generate_requests(PROTOTYPES["normal"], 30,
                                     base_rate=8.0, seed=3))
        return eng

    def test_phase_switches_billed_once_each(self):
        """A mixed phased iteration actuates pf then de: exactly 2
        transitions per iteration in steady state, each billed the
        hardware's transition energy and latency."""
        hw = A6000_MEASURED
        assert hw.dvfs_transition_cost_j > 0.0
        eng = InferenceEngine(CFG, EngineConfig(), hardware=hw,
                              initial_frequency=1170.0)
        eng.set_phase_frequencies(1395.0, 1170.0)
        plan = _mixed_plan()
        c = eng.metrics.c
        for _ in range(2):            # steady state: de clock live at entry
            n0, e0, t0 = (c.freq_transitions_total, c.energy_joules_total,
                          eng.clock)
            eng._execute_phased(plan)
            assert c.freq_transitions_total - n0 == 2   # ->pf, then ->de
            assert c.energy_joules_total - e0 == \
                pytest.approx(2 * hw.dvfs_transition_cost_j)
            assert eng.clock - t0 == \
                pytest.approx(2 * hw.dvfs_transition_s)
        # equal pair at the live clock: no transition, nothing billed
        eng.set_phase_frequencies(1170.0, 1170.0)
        n0, e0 = c.freq_transitions_total, c.energy_joules_total
        eng._execute_phased(plan)
        assert c.freq_transitions_total == n0
        assert c.energy_joules_total == e0

    def test_scalar_set_frequency_reverts_to_1d(self):
        eng = self._engine()
        eng.set_phase_frequencies(1395.0, 1170.0)
        assert eng.freq_targets == (1395.0, 1170.0)
        eng.set_frequency(1200.0)
        assert eng.freq_targets is None
        assert eng.frequency == 1200.0

    def test_targets_clamped_to_envelope(self):
        eng = self._engine()
        eng.set_phase_frequencies(99.0, 1e6)
        assert eng.freq_targets == (A6000.f_min, A6000.f_max)

    def test_phased_drain_finishes_everything(self):
        eng = self._engine()
        eng.set_phase_frequencies(1395.0, 1170.0)
        eng.drain()
        assert len(eng.finished) == 30
        assert all(r.generated == r.output_len for r in eng.finished)


class TestPairBank:
    PAIRS = [(1200.0, 1000.0), (1200.0, 1200.0), (1400.0, 1000.0),
             (1400.0, 1200.0), (1600.0, 1400.0)]

    def test_set_band_intersects_both_axes(self):
        bank = LinUCBBank(self.PAIRS, dim=3)
        bank.set_band(1100.0, 1450.0)
        legal = {f for f in bank.frequencies if bank.is_legal(f)}
        assert legal == {(1200.0, 1200.0), (1400.0, 1200.0)}
        bank.set_band(500.0, 2000.0)           # reversible
        assert all(bank.is_legal(f) for f in bank.frequencies)

    def test_empty_band_falls_back_to_nearest_pair(self):
        bank = LinUCBBank(self.PAIRS, dim=3)
        bank.set_band(1290.0, 1330.0)          # no pair fully inside
        legal = [f for f in bank.frequencies if bank.is_legal(f)]
        assert legal == [(1400.0, 1200.0)]     # nearest to (1310, 1310)

    def test_cascade_prunes_axis_dominated_pairs_only(self):
        f_max = 2100.0
        bank = LinUCBBank(self.PAIRS + [(900.0, 800.0), (800.0, 900.0),
                                        (700.0, 700.0)], dim=3)
        pr = PruningFramework(PruningConfig(min_arms=3), f_max)
        pr._cascade(bank, (900.0, 800.0), round_idx=1)
        left = set(bank.frequencies)
        # (700, 700) is dominated on both axes; (800, 900) is not
        assert (700.0, 700.0) not in left
        assert (800.0, 900.0) in left
        # a pair with one fast axis never triggers a cascade
        pr._cascade(bank, (1600.0, 800.0), round_idx=2)
        assert set(bank.frequencies) == left

    def test_refinement_builds_product_grid_in_band(self):
        cfg = RefinementConfig(interval=1, maturity_threshold=0,
                               half_range_2d_mhz=90.0, step_2d_mhz=45.0)
        ref = MixedMaturityRefinement(cfg, 500.0, 2100.0, ucb_alpha=0.5)
        bank = LinUCBBank(self.PAIRS, dim=3)
        bank.set_band(1150.0, 1460.0)
        pr = PruningFramework(PruningConfig(), 2100.0)
        anchor = ref.maybe_refine(bank, pr, np.zeros(3), 100)
        assert isinstance(anchor, tuple)
        for a, b in bank.frequencies:
            assert 1150.0 <= a <= 1460.0 and 1150.0 <= b <= 1460.0
            assert abs(a - anchor[0]) <= 90.0 + 1e-9
            assert abs(b - anchor[1]) <= 90.0 + 1e-9


class TestPhasedPolicies:
    def _served(self, policy, n=120, **kw):
        eng = InferenceEngine(CFG, EngineConfig(),
                              initial_frequency=A6000.f_max)
        eng.submit(generate_requests(PROTOTYPES["normal"], n,
                                     base_rate=4.0, seed=9))
        pol = get_policy(policy, hardware=A6000, **kw)
        eng.drain(policy=pol)
        return eng, pol

    def test_agft_2d_learns_pairs_end_to_end(self):
        eng, pol = self._served("agft-2d")
        assert isinstance(pol, AGFT2DTuner)
        assert len(eng.finished) == 120
        assert pol.seed_pair == phase_optimal_frequencies(
            A6000, CFG, dvfs=eng.backend.dvfs,
            prefill_chunk=eng.cfg.prefill_chunk,
            decode_seqs=eng.cfg.max_num_seqs // 2)
        acts = [h["freq"] for h in pol.history]
        assert acts and all(isinstance(f, tuple) and len(f) == 2
                            for f in acts)
        assert eng.freq_targets == pol.prev_action

    def test_greenllm_rule_pins_the_analytic_pair(self):
        eng, pol = self._served("greenllm-rule")
        assert len(eng.finished) == 120
        assert eng.freq_targets == pol._pair
        assert pol._pair[0] > pol._pair[1]

    def test_agft_2d_respects_band(self):
        eng, pol = self._served("agft-2d", n=60)
        pol.set_band(1200.0, 1400.0)
        f = pol.act(eng)
        assert 1200.0 <= f[0] <= 1400.0 and 1200.0 <= f[1] <= 1400.0

    def test_agft_2d_factory_rejects_cfg_plus_kwargs(self):
        with pytest.raises(TypeError):
            get_policy("agft-2d", hardware=A6000, cfg=AGFTConfig(),
                       strategy="thompson")

    def test_batched_mode_refuses_phased_policies(self):
        cl = ServingCluster(CFG, n_nodes=2, with_tuners=False,
                            policies=["greenllm-rule", None],
                            step_mode="batched")
        cl.submit(generate_requests(PROTOTYPES["normal"], 20,
                                    base_rate=4.0, seed=1))
        with pytest.raises(NotImplementedError, match="phased"):
            cl.drain()

    def test_batched_mode_refuses_phased_engines(self):
        cl = ServingCluster(CFG, n_nodes=2, with_tuners=False,
                            step_mode="batched")
        cl.engines[0].set_phase_frequencies(1395.0, 1170.0)
        cl.submit(generate_requests(PROTOTYPES["normal"], 20,
                                    base_rate=4.0, seed=1))
        with pytest.raises(NotImplementedError, match="phase"):
            cl.drain()


class TestOneDBitIdentity:
    """The 2-D generalization must not move a single byte of the 1-D
    contract: scalar banks, pruning, refinement and the engine's 1-D
    pricing path are arithmetically untouched (CI's golden-drift job
    runs the same comparison in a fresh process)."""

    @pytest.mark.parametrize("path,gen", generate_golden.GOLDENS,
                             ids=["iteration", "tick"])
    def test_1d_trajectory_reproduces_committed_golden_bytes(self, path,
                                                             gen):
        with open(path) as f:
            committed = f.read()
        assert generate_golden.render(gen()) == committed


class TestAdmissionCap:
    def test_cap_clamps_and_restores(self):
        eng = InferenceEngine(CFG, EngineConfig(max_num_seqs=32))
        sched = eng.sched
        sched.set_admission_cap(8)
        assert sched.max_num_seqs == 8
        sched.set_admission_cap(1000)     # never above the configured base
        assert sched.max_num_seqs == 32
        sched.set_admission_cap(0)        # floor of one sequence
        assert sched.max_num_seqs == 1
        sched.set_admission_cap(None)
        assert sched.max_num_seqs == 32

    def test_capped_engine_still_drains(self):
        eng = InferenceEngine(CFG, EngineConfig(max_num_seqs=32))
        eng.sched.set_admission_cap(2)
        eng.submit(generate_requests(PROTOTYPES["normal"], 25,
                                     base_rate=6.0, seed=5))
        eng.drain()
        assert len(eng.finished) == 25
