"""PR-3 hot-path regression net: the vectorized structure-of-arrays
LinUCB bank vs a per-arm reference implementation, deterministic arm
ordering, the precomputed CostModel/DVFS table vs the explicit formulas,
golden AGFT decision-trajectory regression, the parallel benchmark map,
and the empty-run metric guards."""
import json
import os
import warnings

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core import AGFTTuner, LinUCBArm, LinUCBBank
from repro_torch.energy import A6000, CostModel, DVFSModel, iteration_cost
from repro_torch.energy.costs import (active_param_count, attention_layers,
                                kv_bytes_per_token_layer)
from repro_torch.serving import EngineConfig, InferenceEngine
from repro_torch.workloads import PROTOTYPES, generate_requests

GOLDEN = os.path.join(os.path.dirname(__file__),
                      "golden_agft_decisions.json")


# ---------------------------------------------------------------------------
# Reference (pre-vectorization) bank: dict of per-arm objects
# ---------------------------------------------------------------------------

class RefBank:
    """The historical dict-of-arms implementation, kept verbatim as the
    numerical reference the vectorized bank must agree with."""

    def __init__(self, frequencies, dim, ridge=1.0, seed=0):
        self.dim = dim
        self.ridge = ridge
        self.rng = np.random.default_rng(seed)
        self.arms = {float(f): LinUCBArm(dim, ridge) for f in frequencies}

    @property
    def frequencies(self):
        return sorted(self.arms.keys())

    def remove(self, f):
        self.arms.pop(float(f), None)

    def rebuild(self, frequencies, warm_from=None):
        proto = self.arms.get(float(warm_from)) if warm_from is not None \
            else None
        new = {}
        for f in sorted({float(g) for g in frequencies}):
            arm = self.arms.get(f)
            if arm is None:
                arm = LinUCBArm(self.dim, self.ridge)
                if proto is not None and proto.n > 0:
                    arm.A = proto.A.copy()
                    arm.A_inv = proto.A_inv.copy()
                    arm.b = proto.b.copy()
                    arm.theta = proto.theta.copy()
                    arm.n = proto.n
                    arm.reward_sum = proto.reward_sum
                    arm.edp_sum = proto.edp_sum
            new[f] = arm
        self.arms = new

    def select_ucb(self, x, alpha):
        untried = [f for f, a in self.arms.items() if a.n == 0]
        if untried:
            return min(untried)
        return max(self.arms, key=lambda f: self.arms[f].ucb(x, alpha))

    def select_thompson(self, x, nu=0.3):
        best_f, best_v = None, -np.inf
        for f, arm in self.arms.items():
            try:
                L = np.linalg.cholesky(
                    (arm.A_inv + arm.A_inv.T) / 2.0
                    + 1e-12 * np.eye(self.dim))
            except np.linalg.LinAlgError:
                L = np.eye(self.dim)
            theta_s = arm.theta + nu * L @ self.rng.standard_normal(self.dim)
            v = float(theta_s @ x)
            if v > best_v:
                best_f, best_v = f, v
        return best_f

    def select_greedy(self, x):
        return max(self.arms, key=lambda f: self.arms[f].predict(x))

    def best_historical(self, min_samples=1):
        cands = {f: a for f, a in self.arms.items() if a.n >= min_samples}
        if not cands:
            return None
        return min(cands, key=lambda f: cands[f].mean_edp)


class TestVectorizedBankEquivalence:
    FREQS = [210.0 + 90.0 * k for k in range(18)]

    def _assert_stats_match(self, bank, ref):
        assert bank.frequencies == ref.frequencies
        for f in ref.frequencies:
            v, a = bank.arms[f], ref.arms[f]
            assert v.n == a.n
            np.testing.assert_allclose(v.A_inv, a.A_inv,
                                       rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(v.theta, a.theta,
                                       rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(v.b, a.b, rtol=1e-10, atol=1e-12)

    def test_random_update_rebuild_remove_script(self):
        """Same selections and same sufficient statistics (to 1e-10) as the
        per-arm reference over a randomized update/rebuild/remove script."""
        dim = 7
        bank = LinUCBBank(self.FREQS, dim=dim)
        ref = RefBank(self.FREQS, dim=dim)
        rng = np.random.default_rng(42)
        for step in range(300):
            x = rng.uniform(0, 1.5, dim)
            op = rng.random()
            if op < 0.6:                                   # credit an arm
                f = ref.frequencies[rng.integers(len(ref.frequencies))]
                r = float(rng.normal(-1.0, 0.3))
                edp = float(rng.uniform(1, 30))
                bank.arms[f].update(x, r, edp=edp)
                ref.arms[f].update(x, r, edp=edp)
            elif op < 0.75:                                # selections agree
                alpha = float(rng.uniform(0.2, 1.5))
                assert bank.select_ucb(x, alpha) == ref.select_ucb(x, alpha)
                assert bank.select_greedy(x) == ref.select_greedy(x)
                ms = int(rng.integers(1, 5))
                assert bank.best_historical(ms) == ref.best_historical(ms)
            elif op < 0.85 and len(ref.arms) > 4:          # remove
                f = ref.frequencies[rng.integers(len(ref.frequencies))]
                bank.remove(f)
                ref.remove(f)
            else:                                          # refine/rebuild
                anchor = ref.frequencies[
                    rng.integers(len(ref.frequencies))]
                grid = [max(210.0, min(1800.0, anchor + 15.0 * k))
                        for k in range(-5, 6)]
                bank.rebuild(grid, warm_from=anchor)
                ref.rebuild(grid, warm_from=anchor)
            if step % 25 == 0:
                self._assert_stats_match(bank, ref)
        self._assert_stats_match(bank, ref)

    def test_thompson_matches_reference_stream(self):
        """Same seed, same arm order -> identical RNG-draw-to-arm pairing
        and identical Thompson selections."""
        dim = 4
        bank = LinUCBBank(self.FREQS, dim=dim, seed=9)
        ref = RefBank(sorted(self.FREQS), dim=dim, seed=9)
        rng = np.random.default_rng(3)
        for _ in range(60):
            x = rng.uniform(0, 1, dim)
            f = ref.frequencies[rng.integers(len(ref.frequencies))]
            r = float(rng.normal(-1.0, 0.2))
            bank.arms[f].update(x, r)
            ref.arms[f].update(x, r)
        for _ in range(20):
            x = rng.uniform(0, 1, dim)
            assert bank.select_thompson(x, 0.3) == ref.select_thompson(x, 0.3)

    def test_batched_update_matches_sequential(self):
        dim = 5
        b1 = LinUCBBank(self.FREQS[:6], dim=dim)
        b2 = LinUCBBank(self.FREQS[:6], dim=dim)
        rng = np.random.default_rng(11)
        fs = self.FREQS[:4]
        X = rng.uniform(0, 1, (4, dim))
        r = rng.normal(-1, 0.2, 4)
        edp = rng.uniform(1, 10, 4)
        for i, f in enumerate(fs):
            b1.arms[f].update(X[i], float(r[i]), edp=float(edp[i]))
        b2.update_arms(fs, X, r, edps=edp)
        for f in fs:
            np.testing.assert_allclose(b1.arms[f].A_inv, b2.arms[f].A_inv,
                                       rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(b1.arms[f].theta, b2.arms[f].theta,
                                       rtol=1e-10, atol=1e-12)
            assert b1.arms[f].n == b2.arms[f].n

    def test_batched_update_rejects_duplicate_arms(self):
        bank = LinUCBBank(self.FREQS[:4], dim=3)
        with pytest.raises(ValueError, match="distinct"):
            bank.update_arms([self.FREQS[0], self.FREQS[0]],
                             np.ones((2, 3)), [0.1, 0.2])


class TestDeterministicArmOrder:
    def test_iteration_order_is_ascending_regardless_of_history(self):
        bank = LinUCBBank([1200.0, 300.0, 900.0], dim=3)
        assert list(bank.arms) == [300.0, 900.0, 1200.0]
        # rebuild handing frequencies in descending order
        bank.rebuild([1500.0, 600.0, 900.0], warm_from=900.0)
        assert list(bank.arms) == [600.0, 900.0, 1500.0]
        assert bank.frequencies == [600.0, 900.0, 1500.0]
        bank.remove(900.0)
        assert list(bank.arms) == [600.0, 1500.0]

    def test_selection_tiebreak_and_rng_pairing_order_invariant(self):
        """Two banks whose action spaces were assembled in opposite orders
        make identical selections — tie-breaks and Thompson draws no longer
        depend on rebuild() history."""
        dim = 3
        up = LinUCBBank([600.0, 900.0, 1200.0], dim=dim, seed=5)
        down = LinUCBBank([1200.0, 900.0, 600.0], dim=dim, seed=5)
        x = np.array([1.0, 0.5, 0.2])
        # untried sweep: both start from the lowest frequency
        assert up.select_ucb(x, 0.5) == down.select_ucb(x, 0.5) == 600.0
        for bank in (up, down):
            for f in bank.frequencies:
                bank.arms[f].update(x, -1.0, edp=5.0)
        assert up.select_ucb(x, 0.5) == down.select_ucb(x, 0.5)
        assert up.select_greedy(x) == down.select_greedy(x)
        assert up.select_thompson(x) == down.select_thompson(x)


# ---------------------------------------------------------------------------
# Physics layer: precomputed CostModel / DVFS table vs explicit formulas
# ---------------------------------------------------------------------------

ARCHS = ["llama3-3b", "tinyllama-1.1b"]


class TestCostModel:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_matches_explicit_formula(self, arch):
        cfg = get_config(arch)
        cm = CostModel(cfg)
        rng = np.random.default_rng(0)
        for _ in range(50):
            pf = int(rng.integers(0, 512))
            dec = int(rng.integers(0, 64))
            ctx = float(rng.uniform(0, 4096))
            flops, mem = cm.iteration_cost(prefill_tokens=pf,
                                           decode_seqs=dec, avg_context=ctx)
            # explicit (pre-hoisting) formula, recomputed from primitives
            n_active = active_param_count(cfg)
            attn_l = attention_layers(cfg)
            d_attn = cfg.num_heads * cfg.head_dim
            window = cfg.attention_window or 0
            tokens = pf + dec
            eff = min(ctx, window) if window else ctx
            ref_flops = 2.0 * n_active * tokens
            ref_flops += 4.0 * d_attn * attn_l * (
                pf * max(eff, 1.0) * 0.5 + dec * max(eff, 1.0))
            kv_l = kv_bytes_per_token_layer(cfg, 2) * attn_l
            ref_mem = n_active * 2
            ref_mem += tokens * kv_l
            ref_mem += dec * kv_l * max(eff, 1.0)
            ref_mem += pf * kv_l * 0.1
            assert flops == ref_flops
            assert mem == ref_mem

    def test_functional_api_uses_cached_model(self):
        cfg = get_config("llama3-3b")
        a = iteration_cost(cfg, prefill_tokens=32, decode_seqs=8,
                           avg_context=500.0)
        b = CostModel(cfg).iteration_cost(prefill_tokens=32, decode_seqs=8,
                                          avg_context=500.0)
        assert a == b


class TestDVFSTable:
    def test_table_matches_scalar_formula_on_and_off_grid(self):
        sp = A6000
        model = DVFSModel(sp)
        rng = np.random.default_rng(1)
        freqs = sp.frequencies() + [707.0, 1033.3]        # off-grid too
        for f in freqs:
            flops = float(rng.uniform(1e9, 1e13))
            mem = float(rng.uniform(1e6, 1e11))
            t, p = model.iteration_time_power(flops, mem, f)
            fr = min(max(f / sp.f_max, 1e-3), 1.0)
            thr = fr if fr <= sp.perf_knee else sp.perf_knee \
                + sp.perf_slope_above_knee * (fr - sp.perf_knee)
            t_comp = flops / (sp.peak_flops * thr)
            bw = min(1.0, (fr / sp.bw_knee) ** sp.bw_beta)
            t_mem = mem / (sp.mem_bw * bw)
            t_busy = max(t_comp, t_mem)
            t_ref = t_busy + sp.iteration_overhead_s
            u_busy, u_mem = t_busy / t_ref, t_mem / t_ref
            p_ref = (sp.p_idle + sp.p_static_active * u_busy
                     + sp.p_dyn_compute * u_busy * fr ** sp.alpha
                     + sp.p_dyn_memory * u_mem)
            assert t == t_ref
            assert p == p_ref

    def test_zero_work_is_idle(self):
        model = DVFSModel(A6000)
        t, p = model.iteration_time_power(0.0, 0.0, 1200.0)
        assert p == A6000.p_idle
        assert t == A6000.iteration_overhead_s


# ---------------------------------------------------------------------------
# Golden AGFT decision-history regression (CostModel + vectorized bank)
# ---------------------------------------------------------------------------

class TestGoldenDecisionTrajectory:
    def test_regression_trace_reproduces_golden(self):
        """The exact decision sequence captured on the pre-vectorization
        code must survive the CostModel + SoA-bank hot path."""
        with open(GOLDEN) as f:
            gold = json.load(f)
        tr = gold["trace"]
        eng = InferenceEngine(get_config("llama3-3b"), EngineConfig(),
                              initial_frequency=A6000.f_max)
        eng.submit(generate_requests(PROTOTYPES[tr["workload"]], tr["n"],
                                     base_rate=tr["rate"], seed=tr["seed"]))
        tuner = AGFTTuner(A6000)
        eng.drain(policy=tuner)
        assert [h["freq"] for h in tuner.history] == gold["freqs"]
        assert [h["phase"] for h in tuner.history] == gold["phases"]
        assert tuner.round == gold["rounds"]
        assert eng.metrics.c.energy_joules_total == pytest.approx(
            gold["energy_j"], rel=1e-9)
        assert eng.clock == pytest.approx(gold["clock"], rel=1e-9)


# ---------------------------------------------------------------------------
# Parallel benchmark harness + empty-run guards
# ---------------------------------------------------------------------------

def _square(v):
    return v * v


class TestParallelMap:
    def test_order_preserving_and_parallel(self):
        from benchmarks.parallel import pmap
        items = list(range(12))
        assert pmap(_square, items, jobs=2) == [v * v for v in items]

    def test_serial_fallbacks(self):
        from benchmarks.parallel import pmap
        assert pmap(_square, [3], jobs=8) == [9]
        assert pmap(_square, [1, 2, 3], jobs=1) == [1, 4, 9]

    def test_nested_call_degrades_to_serial(self, monkeypatch):
        import benchmarks.parallel as par
        monkeypatch.setenv("REPRO_BENCH_WORKER", "1")
        assert par.in_worker()
        assert par.pmap(_square, [2, 4], jobs=4) == [4, 16]


class TestPerfBaselineGate:
    def _row(self, us, kind="per_iteration", derived="ok", wall=1.0):
        return {"wall_s": wall, "us_per_call": us, "us_kind": kind,
                "derived": derived}

    def test_gate_fails_on_error_and_big_iteration_regression(self):
        from benchmarks.run import check_against_baseline
        base = {"benchmarks": {"fig5": self._row(40.0),
                               "tab6": self._row(1e6, kind="wall")}}
        cur = {"benchmarks": {"fig5": self._row(90.0),
                              "tab6": self._row(9e6, kind="wall"),
                              "fig7": self._row(0.0, derived="ERROR(x)")}}
        fails = check_against_baseline(cur, base)
        assert any("fig5" in f for f in fails)       # >2x per-iteration
        assert any("ERROR" in f for f in fails)      # errored cell
        assert not any("tab6" in f for f in fails)   # wall rows not gated

    def test_gate_passes_within_threshold(self):
        from benchmarks.run import check_against_baseline
        base = {"benchmarks": {"fig5": self._row(40.0)}}
        cur = {"benchmarks": {"fig5": self._row(75.0)}}
        assert check_against_baseline(cur, base) == []


class TestEmptyRunGuards:
    def test_zero_finished_requests_yield_nan_not_warning(self):
        from benchmarks.common import run_workload
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            row = run_workload("normal", n_requests=0)
        assert row["finished"] == 0
        assert np.isnan(row["ttft_s"])
        assert np.isnan(row["tpot_s"])

    def test_mean_helper(self):
        from benchmarks.common import _mean
        assert np.isnan(_mean([]))
        assert _mean([1.0, 3.0]) == 2.0
