"""Unit tests for the AGFT decision stack: LinUCB math, Page-Hinkley,
pruning mechanisms, refinement, reward normalization, feature extraction."""
import numpy as np

from repro_torch.core import (ConvergenceConfig, ConvergenceDetector,
                        FeatureExtractor, LinUCBArm, LinUCBBank, PageHinkley,
                        PruningConfig, PruningFramework, RefinementConfig,
                        MixedMaturityRefinement, RewardCalculator,
                        RewardConfig)
from repro_torch.energy.edp import WindowStats


def make_window(**kw):
    base = dict(duration_s=0.8, energy_j=100.0, busy_s=0.6,
                prefill_tokens=500, cached_prompt_tokens=0,
                generation_tokens=300, iterations=40, requests_running=8,
                requests_waiting=0, gpu_cache_usage=0.4, cache_hit_rate=0.1)
    base.update(kw)
    return WindowStats(**base)


# ---------------------------------------------------------------------------
# LinUCB
# ---------------------------------------------------------------------------

class TestLinUCB:
    def test_sherman_morrison_matches_direct_inverse(self):
        rng = np.random.default_rng(0)
        arm = LinUCBArm(dim=7)
        for _ in range(50):
            arm.update(rng.uniform(0, 1, 7), rng.normal())
        np.testing.assert_allclose(arm.A_inv, np.linalg.inv(arm.A),
                                   rtol=1e-8, atol=1e-10)

    def test_theta_is_ridge_solution(self):
        rng = np.random.default_rng(1)
        arm = LinUCBArm(dim=4)
        X, r = [], []
        for _ in range(30):
            x = rng.uniform(0, 1, 4)
            rew = float(x @ np.array([1.0, -2.0, 0.5, 0.0]) + 0.01)
            arm.update(x, rew)
            X.append(x)
            r.append(rew)
        X = np.array(X)
        r = np.array(r)
        theta_direct = np.linalg.solve(np.eye(4) + X.T @ X, X.T @ r)
        np.testing.assert_allclose(arm.theta, theta_direct, rtol=1e-8)

    def test_learns_linear_reward_and_selects_best_arm(self):
        rng = np.random.default_rng(2)
        bank = LinUCBBank([600.0, 1200.0, 1800.0], dim=3)
        true = {600.0: np.array([-2.0, 0.0, 0.1]),
                1200.0: np.array([-0.5, 0.2, 0.0]),
                1800.0: np.array([-1.0, -0.1, 0.3])}
        for _ in range(400):
            x = rng.uniform(0, 1, 3)
            f = bank.select_ucb(x, alpha=0.5)
            r = float(true[f] @ x + 0.05 * rng.normal())
            bank.arms[f].update(x, r)
        x = np.array([1.0, 0.5, 0.5])
        assert bank.select_greedy(x) == 1200.0

    def test_ucb_bonus_shrinks_with_samples(self):
        arm = LinUCBArm(dim=3)
        x = np.array([1.0, 0.5, 0.2])
        b0 = arm.ucb(x, 1.0) - arm.predict(x)
        for _ in range(20):
            arm.update(x, -1.0)
        b1 = arm.ucb(x, 1.0) - arm.predict(x)
        assert b1 < b0

    def test_rebuild_warm_start(self):
        bank = LinUCBBank([900.0, 1200.0], dim=2)
        x = np.array([1.0, 0.5])
        for _ in range(10):
            bank.arms[1200.0].update(x, -0.8)
        bank.rebuild([1185.0, 1200.0, 1215.0], warm_from=1200.0)
        assert bank.arms[1215.0].n == 10                 # inherited prior
        assert bank.arms[1200.0].n == 10                 # survived intact
        assert 900.0 not in bank.arms


# ---------------------------------------------------------------------------
# Page-Hinkley / convergence
# ---------------------------------------------------------------------------

class TestPageHinkley:
    def test_no_alarm_on_stationary(self):
        rng = np.random.default_rng(3)
        ph = PageHinkley(delta=0.1, threshold=2.0)
        alarms = sum(ph.update(-1 + 0.05 * rng.normal()) for _ in range(500))
        assert alarms == 0

    def test_alarm_on_mean_shift(self):
        rng = np.random.default_rng(4)
        ph = PageHinkley(delta=0.1, threshold=2.0)
        for _ in range(100):
            ph.update(-1 + 0.05 * rng.normal())
        fired = any(ph.update(-3 + 0.05 * rng.normal()) for _ in range(60))
        assert fired

    def test_convergence_then_drift_reopens(self):
        rng = np.random.default_rng(5)
        det = ConvergenceDetector(ConvergenceConfig(
            stable_rounds=20, std_threshold=0.3))
        for _ in range(80):
            det.update(-1 + 0.1 * rng.normal())
        assert det.converged
        assert det.converged_round is not None
        for _ in range(80):
            det.update(-4 + 0.1 * rng.normal())
        assert det.reopened >= 1


# ---------------------------------------------------------------------------
# Pruning
# ---------------------------------------------------------------------------

class TestPruning:
    def _bank(self, freqs, dim=3):
        return LinUCBBank([float(f) for f in freqs], dim=dim)

    def test_extreme_pruning_removes_pathological_arm(self):
        bank = self._bank([300, 900, 1500])
        pruner = PruningFramework(PruningConfig(min_arms=2), f_max=1800)
        x = np.ones(3)
        for _ in range(4):
            bank.arms[300.0].update(x, -2.0, edp=10)   # far below -1.2
            bank.arms[900.0].update(x, -1.0, edp=5)
            bank.arms[1500.0].update(x, -1.0, edp=5)
        pruner.apply(bank, round_idx=10)
        assert 300.0 not in bank.arms
        assert any(e["mechanism"] == "extreme" for e in pruner.log)

    def test_extreme_pruning_only_in_early_phase(self):
        bank = self._bank([300, 900, 1500])
        pruner = PruningFramework(
            PruningConfig(early_rounds=60, min_arms=2,
                          historical_min_samples=100), f_max=1800)
        x = np.ones(3)
        for _ in range(4):
            bank.arms[300.0].update(x, -2.0, edp=10)
        pruner.apply(bank, round_idx=100)              # past early phase
        assert 300.0 in bank.arms

    def test_historical_pruning(self):
        bank = self._bank([600, 1200, 1800])
        pruner = PruningFramework(PruningConfig(min_arms=1), f_max=1800)
        x = np.ones(3)
        for _ in range(8):
            bank.arms[600.0].update(x, -1.0, edp=30.0)   # much worse EDP
            bank.arms[1200.0].update(x, -1.0, edp=5.0)
            bank.arms[1800.0].update(x, -1.0, edp=7.0)
        pruner.apply(bank, round_idx=50)
        assert 600.0 not in bank.arms
        assert 1200.0 in bank.arms

    def test_cascade_prunes_everything_below(self):
        bank = self._bank([210, 400, 700, 1200, 1800])
        pruner = PruningFramework(PruningConfig(min_arms=2), f_max=1800)
        x = np.ones(3)
        for _ in range(4):
            bank.arms[700.0].update(x, -2.0, edp=10)     # extreme at 700 MHz
            bank.arms[1200.0].update(x, -0.9, edp=3)
            bank.arms[1800.0].update(x, -1.0, edp=4)
        pruner.apply(bank, round_idx=10)
        # 700 < 0.5*1800 -> cascade removes 210 and 400 too
        assert all(f not in bank.arms for f in (210.0, 400.0, 700.0))

    def test_min_arms_floor(self):
        bank = self._bank([600, 1200])
        pruner = PruningFramework(PruningConfig(min_arms=2), f_max=1800)
        x = np.ones(3)
        for _ in range(4):
            bank.arms[600.0].update(x, -3.0, edp=99)
        pruner.apply(bank, round_idx=5)
        assert len(bank.arms) == 2                     # floor respected

    def test_refinement_never_resurrects_pruned(self):
        bank = self._bank([600, 1200, 1800])
        pruner = PruningFramework(PruningConfig(min_arms=1), f_max=1800)
        pruner.permanently_pruned.add(1215.0)
        ref = MixedMaturityRefinement(RefinementConfig(interval=1),
                                      210, 1800)
        x = np.ones(3)
        for _ in range(6):
            bank.arms[1200.0].update(x, -0.9, edp=2)
        ref.maybe_refine(bank, pruner, x, round_idx=50)
        assert 1215.0 not in bank.arms
        assert 1200.0 in bank.arms


# ---------------------------------------------------------------------------
# Refinement
# ---------------------------------------------------------------------------

class TestRefinement:
    def test_statistical_anchor_before_maturity(self):
        bank = LinUCBBank([600.0, 1200.0, 1800.0], dim=3)
        pruner = PruningFramework(PruningConfig(), f_max=1800)
        ref = MixedMaturityRefinement(
            RefinementConfig(interval=10, maturity_threshold=100), 210, 1800)
        x = np.ones(3)
        for _ in range(5):
            bank.arms[1200.0].update(x, -0.9, edp=2.0)
            bank.arms[600.0].update(x, -1.2, edp=9.0)
            bank.arms[1800.0].update(x, -1.0, edp=4.0)
        anchor = ref.maybe_refine(bank, pruner, x, round_idx=50)
        assert anchor == 1200.0
        assert ref.log[-1]["mode"] == "statistical"
        freqs = bank.frequencies
        assert min(freqs) >= 1050.0 and max(freqs) <= 1350.0
        assert all(abs((f - 1050.0) % 15.0) < 1e-6 for f in freqs)

    def test_predictive_anchor_after_maturity(self):
        bank = LinUCBBank([600.0, 1200.0], dim=3)
        pruner = PruningFramework(PruningConfig(), f_max=1800)
        ref = MixedMaturityRefinement(
            RefinementConfig(interval=10, maturity_threshold=100), 210, 1800)
        x = np.ones(3)
        for _ in range(5):
            bank.arms[600.0].update(x, -0.5, edp=1.0)   # best predicted
            bank.arms[1200.0].update(x, -1.5, edp=5.0)
        anchor = ref.maybe_refine(bank, pruner, x, round_idx=200)
        assert anchor == 600.0
        assert ref.log[-1]["mode"] == "predictive"

    def test_no_refinement_off_interval(self):
        bank = LinUCBBank([600.0], dim=3)
        pruner = PruningFramework(PruningConfig(), f_max=1800)
        ref = MixedMaturityRefinement(RefinementConfig(interval=25), 210, 1800)
        assert ref.maybe_refine(bank, pruner, np.ones(3), 13) is None


# ---------------------------------------------------------------------------
# Reward + features
# ---------------------------------------------------------------------------

class TestRewardAndFeatures:
    def test_reward_near_minus_one_at_reference(self):
        rc = RewardCalculator(RewardConfig(slo_tpot_s=0.0, queue_penalty=0.0))
        w = make_window()
        rs = [rc(w) for _ in range(20)]
        assert abs(rs[-1] + 1.0) < 1e-6

    def test_reward_worse_for_higher_edp(self):
        rc = RewardCalculator(RewardConfig(slo_tpot_s=0.0, queue_penalty=0.0))
        for _ in range(10):
            rc(make_window())
        r_bad = rc(make_window(energy_j=300.0))
        assert r_bad < -1.5

    def test_slo_penalty_applies(self):
        rc = RewardCalculator(RewardConfig(slo_tpot_s=0.001, slo_penalty=2.0,
                                           queue_penalty=0.0))
        for _ in range(10):
            rc(make_window())
        base = rc(make_window())
        rc2 = RewardCalculator(RewardConfig(slo_tpot_s=0.0,
                                            queue_penalty=0.0))
        for _ in range(10):
            rc2(make_window())
        no_slo = rc2(make_window())
        assert base < no_slo

    def test_feature_vector_dimensions_and_bounds(self):
        fx = FeatureExtractor()
        x = fx(make_window(requests_waiting=3))
        assert x.shape == (7,)
        assert x[0] == 1.0                      # has_queue
        assert np.all(x >= 0) and np.all(x <= 1.5)

    def test_features_distinguish_prototype_directions(self):
        fx = FeatureExtractor()
        x_ctx = fx(make_window(prefill_tokens=16000, generation_tokens=50))
        x_gen = fx(make_window(prefill_tokens=50, generation_tokens=3000))
        x_hit = fx(make_window(cache_hit_rate=0.95))
        assert x_ctx[1] > x_gen[1]              # prefill tput separates
        assert x_gen[2] > x_ctx[2]              # decode tput separates
        assert x_hit[6] > 0.9                   # hit rate separates


class TestThompsonExtension:
    def test_thompson_selects_within_action_space(self):
        rng = np.random.default_rng(0)
        bank = LinUCBBank([600.0, 1200.0, 1800.0], dim=3, seed=1)
        for _ in range(30):
            x = rng.uniform(0, 1, 3)
            f = bank.select_thompson(x, nu=0.3)
            assert f in bank.arms
            bank.arms[f].update(x, -1.0 + 0.1 * rng.normal())

    def test_thompson_concentrates_on_best_arm(self):
        rng = np.random.default_rng(1)
        bank = LinUCBBank([600.0, 1200.0], dim=2, seed=2)
        x = np.array([1.0, 0.5])
        for _ in range(300):
            f = bank.select_thompson(x, nu=0.3)
            r = -0.5 if f == 1200.0 else -1.5
            bank.arms[f].update(x, r + 0.05 * rng.normal())
        picks = [bank.select_thompson(x, nu=0.3) for _ in range(100)]
        assert picks.count(1200.0) > 80

    def test_tuner_with_thompson_strategy_runs(self):
        from repro_torch.core import AGFTConfig, AGFTTuner
        from repro_torch.energy import A6000
        from repro_torch.serving import EngineConfig, InferenceEngine
        from repro_torch.workloads import PROTOTYPES, generate_requests
        from repro_torch.configs import get_config
        eng = InferenceEngine(get_config("llama3-3b"), EngineConfig(),
                              initial_frequency=A6000.f_max)
        eng.submit(generate_requests(PROTOTYPES["normal"], 150,
                                     base_rate=3.0, seed=9))
        tuner = AGFTTuner(A6000, AGFTConfig(strategy="thompson"))
        eng.drain(policy=tuner)
        assert len(eng.finished) == 150
        assert tuner.round > 0
