"""Stacked AGFT: one vectorized closed loop for a whole fleet of tuners.

The megafleet backend (``repro_torch.serving.fleet_step``) steps thousands of
independent engines in lockstep; invoking a Python :class:`AGFTTuner.act`
per node per decision would dominate its runtime. This module runs the
SAME closed loop — window diff → features → reward → LinUCB credit →
convergence → pruning → refinement → selection — over ``(n_nodes, ...)``
arrays, one numpy dispatch per stage for every node due this round.

Bit-exactness contract: every stage is either (a) an elementwise port of
the scalar tuner arithmetic (same expression, same association order), or
(b) a batched linear-algebra form verified bit-identical to the scalar
bank's BLAS calls (see :class:`repro_torch.core.linucb.StackedBanks`), or (c)
the *actual per-node object* (``PruningFramework``/
``MixedMaturityRefinement``) invoked through a bank view on exactly the
rounds the scalar tuner would invoke it with a mutating outcome —
vectorized prechecks prove the call would be a no-op otherwise. A fleet
driven by :class:`StackedAGFT` therefore produces per-node trajectories
bit-identical to per-node :class:`repro_torch.core.tuner.AGFTTuner` instances.

Only the paper configuration is batchable: ``strategy="linucb"`` with no
fleet band. ``from_tuners`` validates this and refuses anything else (the
caller then falls back to per-node facades).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.linucb import StackedBanks
from repro_torch.core.tuner import AGFTTuner

#: metric-snapshot key order shared with ``repro_torch.serving.fleet_step`` —
#: identical to ``MetricsExporter.snapshot()``; column indices below.
SNAP_KEYS = (
    "vllm:prompt_tokens_total",
    "vllm:cached_prompt_tokens_total",
    "vllm:generation_tokens_total",
    "vllm:iterations_total",
    "vllm:requests_finished_total",
    "vllm:prefix_cache_hits_total",
    "vllm:prefix_cache_queries_total",
    "vllm:energy_joules_total",
    "vllm:busy_seconds_total",
    "vllm:ttft_seconds_total",
    "vllm:ttft_count_total",
    "vllm:freq_transitions_total",
    "vllm:num_requests_running",
    "vllm:num_requests_waiting",
    "vllm:gpu_cache_usage_perc",
    "vllm:current_frequency_mhz",
    "vllm:current_power_watts",
)
_C = {k.split(":")[1]: i for i, k in enumerate(SNAP_KEYS)}


class _PHStack:
    """Vectorized two-sided Page-Hinkley detectors (one per node) —
    elementwise port of :class:`repro_torch.core.page_hinkley.PageHinkley`."""

    def __init__(self, n: int, delta: float, threshold: float,
                 min_samples: int = 10):
        self.delta = delta
        self.threshold = threshold
        self.min_samples = min_samples
        self.n = np.zeros(n, dtype=np.int64)
        self.mean = np.zeros(n)
        self.m_up = np.zeros(n)
        self.m_dn = np.zeros(n)
        self.min_up = np.zeros(n)
        self.max_dn = np.zeros(n)

    def reset(self, k: np.ndarray) -> None:
        self.n[k] = 0
        self.mean[k] = 0.0
        self.m_up[k] = 0.0
        self.m_dn[k] = 0.0
        self.min_up[k] = 0.0
        self.max_dn[k] = 0.0

    def update(self, k: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Feed one observation per node ``k``; True => drift alarm."""
        self.n[k] += 1
        self.mean[k] += (v - self.mean[k]) / self.n[k]
        dev = v - self.mean[k]
        self.m_up[k] += dev - self.delta
        self.m_dn[k] += dev + self.delta
        self.min_up[k] = np.minimum(self.min_up[k], self.m_up[k])
        self.max_dn[k] = np.maximum(self.max_dn[k], self.m_dn[k])
        alarm = (self.n[k] >= self.min_samples) \
            & (((self.m_up[k] - self.min_up[k]) > self.threshold)
               | ((self.max_dn[k] - self.m_dn[k]) > self.threshold))
        if alarm.any():
            self.reset(k[alarm])
        return alarm

class StackedAGFT:
    """The AGFT closed loop over ``(n_nodes,)`` state arrays.

    Constructed from a fleet of PRISTINE per-node tuners
    (:meth:`from_tuners`); per-node pruning/refinement framework objects
    are borrowed from the tuners (their logs and permanently-pruned sets
    accumulate in place), and :meth:`writeback` restores every tuner to
    the exact state its scalar twin would hold after the run.
    """

    def __init__(self, tuners: Sequence[AGFTTuner], *,
                 record_history: bool = True):
        t0 = tuners[0]
        cfg = t0.cfg
        n = len(tuners)
        self.tuners = list(tuners)
        self.cfg = cfg
        self.n_nodes = n
        self.dim = t0.features.dim
        self.scales = cfg.scales
        self.record_history = record_history
        self.period = cfg.sampling_period_s
        self.alpha = cfg.ucb_alpha

        freqs = t0.bank.frequencies
        self.banks = StackedBanks(n, freqs, self.dim, ridge=cfg.ridge)
        self.pruners = [t.pruner for t in tuners]
        self.refiners = [t.refiner for t in tuners]

        # monitor (TelemetryMonitor state, stacked)
        nk = len(SNAP_KEYS)
        self.prev_snap = np.zeros((n, nk))
        self.has_prev = np.zeros(n, dtype=bool)
        self.prev_time = np.zeros(n)
        self.next_sample = np.zeros(n)

        # reward reference (RewardCalculator state)
        self.ref_edp = np.full(n, np.nan)
        self.windows_seen = np.zeros(n, dtype=np.int64)

        # convergence (ConvergenceDetector state)
        ccfg = cfg.convergence
        self.ph = _PHStack(n, ccfg.ph_delta, ccfg.ph_threshold)
        self.ph_drift = _PHStack(n, ccfg.drift_delta, ccfg.drift_threshold)
        self.ring = np.zeros((n, ccfg.std_window))
        self.ring_pos = np.zeros(n, dtype=np.int64)
        self.ring_len = np.zeros(n, dtype=np.int64)
        self.quiet = np.zeros(n, dtype=np.int64)
        self.converged = np.zeros(n, dtype=bool)
        self.converged_round = np.full(n, -1, dtype=np.int64)
        self.first_converged_round = np.full(n, -1, dtype=np.int64)
        self.reopened = np.zeros(n, dtype=np.int64)
        self.conv_round = np.zeros(n, dtype=np.int64)

        # action bookkeeping (AGFTTuner state)
        self.round = np.zeros(n, dtype=np.int64)
        self.prev_action = np.full(n, np.nan)
        self.prev_context = np.zeros((n, self.dim))
        self.prev_switched = np.zeros(n, dtype=bool)
        self.switch_count = np.zeros(n, dtype=np.int64)

    # ------------------------------------------------------------------
    @classmethod
    def from_tuners(cls, policies: Sequence[object], *,
                    record_history: bool = True
                    ) -> Optional["StackedAGFT"]:
        """Build a stacked loop from per-node policies, or ``None`` when
        the fleet isn't batchable: every policy must be a pristine
        ``AGFTTuner`` (round 0, no telemetry seen, no band), using the
        paper's LinUCB strategy, with identical configs and identical
        initial action spaces."""
        if not policies:
            return None
        for p in policies:
            if type(p) is not AGFTTuner:
                return None
            if p.cfg.strategy != "linucb":
                return None
            if (p.round != 0 or p.monitor.prev_snapshot is not None
                    or p.prev_action is not None or p.band is not None
                    or p.history or p.bank._band is not None
                    or p.pruner.permanently_pruned or p.refiner.log):
                return None
        t0 = policies[0]
        ref_cfg = dataclasses.asdict(t0.cfg)
        ref_freqs = t0.bank.frequencies
        for p in policies[1:]:
            if dataclasses.asdict(p.cfg) != ref_cfg:
                return None
            if p.bank.frequencies != ref_freqs:
                return None
        return cls(policies, record_history=record_history)

    # ------------------------------------------------------------------
    def act(self, idx: np.ndarray, snap: np.ndarray, now: np.ndarray,
            actuate=None) -> np.ndarray:
        """One decision per node in ``idx``: ``snap`` rows are the nodes'
        current metric snapshots (``SNAP_KEYS`` order), ``now`` the window
        cut times (engine clocks in iteration mode, tick times in tick
        mode). Returns the chosen frequency per node.

        ``actuate`` (optional) is called with ``(idx, freqs)`` between
        selection and bookkeeping — exactly where the scalar tuner's
        ``_actuate`` calls ``engine.set_frequency`` — and may return the
        per-node history cut times (the scalar history records the
        POST-transition engine clock in iteration mode) or ``None`` to
        keep ``now`` (tick mode, where the cut is the tick time). Without
        the hook the caller actuates afterwards; histories then carry
        ``now``, correct whenever transitions don't advance the clock."""
        out = np.empty(len(idx))
        hp = self.has_prev[idx]
        aux = None
        if not hp.all():
            first = idx[~hp]
            _, f0 = self.banks.select_batch(
                first, np.zeros((len(first), self.dim)), self.alpha,
                np.zeros(len(first), dtype=bool))
            out[~hp] = f0
        if hp.any():
            reg = idx[hp]
            out[hp], aux = self._act_regular(reg, snap[hp], now[hp])
        hist_t = None
        if actuate is not None:
            hist_t = actuate(idx, out)
        if hist_t is None:
            hist_t = now
        if not hp.all():
            self._bookkeep(idx[~hp], out[~hp], None, None, None, None,
                           hist_t[~hp])
        if hp.any():
            reward, edp_plain, energy, tpot, x_t, greedy = aux
            self._bookkeep(idx[hp], out[hp], reward, edp_plain, energy,
                           tpot, hist_t[hp], x_t=x_t, greedy=greedy)
        # re-arm the window (monitor.observe does this on every path)
        self.prev_snap[idx] = snap
        self.has_prev[idx] = True
        self.prev_time[idx] = now
        self.next_sample[idx] = now + self.period
        return out

    # ------------------------------------------------------------------
    def _act_regular(self, reg: np.ndarray, snap: np.ndarray,
                     now: np.ndarray):
        prev = self.prev_snap[reg]
        d = snap - prev
        dur = np.maximum(now - self.prev_time[reg], 1e-9)
        energy = d[:, _C["energy_joules_total"]]
        busy = d[:, _C["busy_seconds_total"]]
        gen = d[:, _C["generation_tokens_total"]]
        pre = d[:, _C["prompt_tokens_total"]]
        iters = d[:, _C["iterations_total"]]
        running = snap[:, _C["num_requests_running"]]
        waiting = snap[:, _C["num_requests_waiting"]]
        usage = snap[:, _C["gpu_cache_usage_perc"]]
        hits = d[:, _C["prefix_cache_hits_total"]]
        queries = d[:, _C["prefix_cache_queries_total"]]
        hit_rate = np.where(queries > 0,
                            hits / np.where(queries > 0, queries, 1.0), 0.0)
        ttft = d[:, _C["ttft_seconds_total"]] \
            / np.maximum(d[:, _C["ttft_count_total"]], 1)
        # effective TPOT: busy/generated, stalled windows pay the duration
        tpot = np.where(gen > 0, busy / np.where(gen > 0, gen, 1.0), dur)

        # features (FeatureExtractor, elementwise)
        s = self.scales
        x_t = np.empty((len(reg), self.dim))
        x_t[:, 0] = np.where(waiting > 0, 1.0, 0.0)
        x_t[:, 1] = (pre / dur) / s.prefill_tput
        x_t[:, 2] = (gen / dur) / s.decode_tput
        x_t[:, 3] = ((pre + gen) / np.maximum(iters, 1)) / s.packing_eff
        x_t[:, 4] = running / s.concurrency
        x_t[:, 5] = usage
        x_t[:, 6] = hit_rate
        np.clip(x_t, 0.0, 1.5, out=x_t)

        # reward (RewardCalculator, elementwise) — prev_action is always
        # set after the first act, so every regular act credits. The switch
        # cost bills only the reward's mixed EDP; the arm credit and the
        # history record keep the window's raw ``edp`` / ``energy_j``.
        rcfg = self.cfg.reward
        self.windows_seen[reg] += 1
        energy_r = energy
        if rcfg.switch_cost_j:
            energy_r = np.where(self.prev_switched[reg],
                                energy + rcfg.switch_cost_j, energy)
        edp_plain = energy * tpot
        edp = np.maximum(energy_r * (tpot + rcfg.ttft_weight * ttft), 1e-12)
        ref = self.ref_edp[reg]
        ws = self.windows_seen[reg]
        ref = np.where(np.isnan(ref), edp,
                       np.where(ws <= rcfg.warmup_windows,
                                ref + (edp - ref) / ws,
                                ref + rcfg.ema * (edp - ref)))
        self.ref_edp[reg] = ref
        reward = -edp / np.maximum(ref, 1e-12)
        if rcfg.slo_tpot_s > 0:
            pen = rcfg.slo_penalty * (tpot / rcfg.slo_tpot_s - 1.0)
            reward = np.where(tpot > rcfg.slo_tpot_s, reward - pen, reward)
        qpen = rcfg.queue_penalty * np.minimum(
            waiting / np.maximum(running, 1), 2.0)
        reward = np.where((waiting > 0) & (running > 0),
                          reward - qpen, reward)

        # credit the previous action (arm may be gone: pruned or dropped
        # by a rebuild — then only convergence still sees the reward)
        slots = self.banks.slots_for(reg, self.prev_action[reg])
        hit = slots >= 0
        if hit.any():
            self.banks.update_rows(reg[hit], slots[hit],
                                   self.prev_context[reg[hit]],
                                   reward[hit], edp_plain[hit])
        self._converge_update(reg, reward)
        self.round[reg] += 1

        # pruning: vectorized precheck gates the per-node framework call
        need = self._pruning_precheck(reg)
        for i in np.flatnonzero(need):
            node = int(reg[i])
            self.pruners[node].apply(self.banks.view(node),
                                     int(self.round[node]))
        # refinement (only while learning) — predictive anchors (the UCB
        # argmax, the dominant per-node cost once the fleet is mature) are
        # batched into one stacked dispatch; the per-node framework call
        # then reuses the precomputed anchor
        rfcfg = self.cfg.refinement
        if rfcfg.enabled:
            rnd = self.round[reg]
            due = (~self.converged[reg]) & (rnd > 0) \
                & (rnd % rfcfg.interval == 0)
            if due.any():
                anchors = {}
                pred = due & (rnd >= rfcfg.maturity_threshold)
                if pred.any():
                    pi = np.flatnonzero(pred)
                    af = self.banks.argmax_ucb_batch(reg[pi], x_t[pi],
                                                     self.alpha)
                    anchors = dict(zip(pi.tolist(), af.tolist()))
                for i in np.flatnonzero(due):
                    node = int(reg[i])
                    self.refiners[node].maybe_refine(
                        self.banks.view(node), self.pruners[node],
                        x_t[i], int(self.round[node]),
                        anchor=anchors.get(i))

        # select: greedy exploitation once converged, UCB otherwise
        greedy = self.converged[reg]
        _, f = self.banks.select_batch(reg, x_t, self.alpha, greedy)
        return f, (reward, edp_plain, energy, tpot, x_t, greedy)

    # ------------------------------------------------------------------
    def _converge_update(self, k: np.ndarray, r: np.ndarray) -> None:
        """Elementwise port of ``ConvergenceDetector.update``."""
        ccfg = self.cfg.convergence
        self.conv_round[k] += 1
        W = ccfg.std_window
        self.ring[k, self.ring_pos[k]] = r
        self.ring_pos[k] = (self.ring_pos[k] + 1) % W
        self.ring_len[k] = np.minimum(self.ring_len[k] + 1, W)
        conv = self.converged[k]
        ck = k[conv]
        if len(ck):
            alarm = self.ph_drift.update(ck, r[conv])
            ak = ck[alarm]
            if len(ak):
                self.converged[ak] = False
                self.converged_round[ak] = -1
                self.quiet[ak] = 0
                self.reopened[ak] += 1
                self.ph.reset(ak)
        uk = k[~conv]
        if len(uk):
            drift = self.ph.update(uk, r[~conv])
            self.quiet[uk] = np.where(drift, 0, self.quiet[uk] + 1)
            cand = self.quiet[uk] >= ccfg.stable_rounds
            if cand.any():
                cku = uk[cand]
                # quiet >= stable_rounds implies a full ring; materialize
                # oldest->newest so np.std sums in deque order
                order = (self.ring_pos[cku][:, None]
                         + np.arange(W)[None, :]) % W
                vals = self.ring[cku[:, None], order]
                ok = np.std(vals, axis=1) <= ccfg.std_threshold
                ck2 = cku[ok]
                if len(ck2):
                    self.converged[ck2] = True
                    self.converged_round[ck2] = self.conv_round[ck2]
                    unset = self.first_converged_round[ck2] < 0
                    self.first_converged_round[ck2[unset]] = \
                        self.conv_round[ck2][unset]
                    self.ph_drift.reset(ck2)

    # ------------------------------------------------------------------
    def _pruning_precheck(self, reg: np.ndarray) -> np.ndarray:
        """True per node iff ``PruningFramework.apply`` COULD mutate the
        bank this round. The early-phase check is exact (same candidate
        predicate); the mature-phase check evaluates the full predicate —
        worst sampled mean EDP beyond BOTH the dynamic std tolerance and
        the 5% relative floor — with the tolerance shrunk by a 1e-9
        relative margin to absorb summation-order drift vs the scalar
        ``np.std`` (a framework call gated in is a no-op whenever the
        exact predicate fails, so erring toward calling is lossless;
        erring away would silently skip a prune and is forbidden)."""
        cfg = self.cfg.pruning
        k = len(reg)
        if not cfg.enabled:
            return np.zeros(k, dtype=bool)
        rnd = self.round[reg]
        banks = self.banks
        K = banks.capacity
        active = np.arange(K)[None, :] < banks.m[reg][:, None]
        n_act = banks.m[reg]
        nn = banks.n_[reg]
        need = np.zeros(k, dtype=bool)
        early = rnd <= cfg.early_rounds
        mature = rnd >= cfg.mature_rounds
        room = n_act > cfg.min_arms
        if early.any():
            with np.errstate(divide="ignore", invalid="ignore"):
                mr = banks.reward_sum[reg] / nn
            cand = active & (nn >= cfg.extreme_min_samples) \
                & (mr < cfg.extreme_reward_threshold)
            need |= early & room & cand.any(axis=1)
        if mature.any():
            sampled = active & (nn >= cfg.historical_min_samples)
            with np.errstate(divide="ignore", invalid="ignore"):
                me = banks.edp_sum[reg] / nn
            mes = np.where(sampled, me, 0.0)
            cnt = sampled.sum(axis=1)
            best = np.min(np.where(sampled, me, np.inf), axis=1)
            worst = np.max(np.where(sampled, me, -np.inf), axis=1)
            # masked two-pass variance of the sampled means — the same
            # arithmetic as the scalar np.std, modulo summation order
            denom = np.maximum(cnt, 1)
            mean = mes.sum(axis=1) / denom
            var = np.where(sampled, (mes - mean[:, None]) ** 2,
                           0.0).sum(axis=1) / denom
            tol = cfg.historical_tolerance_k * np.sqrt(var)
            need |= mature & room & (cnt >= 2) \
                & (worst > best * 1.05) \
                & (worst > best + tol * (1.0 - 1e-9))
        return need

    # ------------------------------------------------------------------
    def _bookkeep(self, idx: np.ndarray, f: np.ndarray, reward, edp,
                  energy, tpot, now, x_t: Optional[np.ndarray] = None,
                  greedy: Optional[np.ndarray] = None) -> None:
        """``AGFTTuner._actuate`` bookkeeping (sans engine actuation)."""
        prev = self.prev_action[idx]
        switched = ~np.isnan(prev) & (f != prev)
        self.prev_switched[idx] = switched
        self.switch_count[idx] += switched
        self.prev_action[idx] = f
        self.prev_context[idx] = x_t if x_t is not None else 0.0
        if not self.record_history:
            return
        m = self.banks.m[idx]
        conv = self.converged[idx]
        for j, node in enumerate(idx):
            if x_t is None:
                entry = {"t": float(now[j]), "freq": float(f[j]),
                         "reward": None, "edp": None, "energy_j": None,
                         "tpot": None, "phase": "warmup",
                         "n_arms": int(m[j]), "converged": bool(conv[j]),
                         "band": None}
            else:
                entry = {"t": float(now[j]), "freq": float(f[j]),
                         "reward": float(reward[j]), "edp": float(edp[j]),
                         "energy_j": float(energy[j]),
                         "tpot": float(tpot[j]),
                         "phase": "exploit" if greedy[j] else "explore",
                         "n_arms": int(m[j]), "converged": bool(conv[j]),
                         "band": None}
            self.tuners[int(node)].history.append(entry)

    # ------------------------------------------------------------------
    def writeback(self) -> None:
        """Restore each tuner to the exact state its scalar twin would
        hold: bank statistics, monitor window, reward reference,
        convergence detector, and action bookkeeping. History (when
        recorded) and pruner/refiner logs accumulated in place already."""
        for i, t in enumerate(self.tuners):
            b = self.banks
            m = int(b.m[i])
            t.bank._alloc([float(x) for x in b.freqs[i, :m]])
            t.bank._A[:] = b.A[i, :m]
            t.bank._A_inv[:] = b.A_inv[i, :m]
            t.bank._b[:] = b.b[i, :m]
            t.bank._theta[:] = b.theta[i, :m]
            t.bank._n[:] = b.n_[i, :m]
            t.bank._reward_sum[:] = b.reward_sum[i, :m]
            t.bank._edp_sum[:] = b.edp_sum[i, :m]
            if self.has_prev[i]:
                t.monitor.prev_snapshot = {
                    k: float(self.prev_snap[i, j])
                    for j, k in enumerate(SNAP_KEYS)}
            t.monitor.prev_time = float(self.prev_time[i])
            t.monitor.next_sample = float(self.next_sample[i])
            if not np.isnan(self.ref_edp[i]):
                t.reward_calc.ref_edp = float(self.ref_edp[i])
            t.reward_calc.windows_seen = int(self.windows_seen[i])
            c = t.convergence
            c.round = int(self.conv_round[i])
            c.quiet_rounds = int(self.quiet[i])
            c.converged = bool(self.converged[i])
            c.converged_round = (int(self.converged_round[i])
                                 if self.converged_round[i] >= 0 else None)
            c.first_converged_round = (
                int(self.first_converged_round[i])
                if self.first_converged_round[i] >= 0 else None)
            c.reopened = int(self.reopened[i])
            L = int(self.ring_len[i])
            order = (int(self.ring_pos[i]) + np.arange(L)) % self.ring.shape[1] \
                if L == self.ring.shape[1] else np.arange(L)
            c.recent.clear()
            c.recent.extend(float(v) for v in self.ring[i, order])
            for src, dst in ((self.ph, c.ph), (self.ph_drift, c.ph_drift)):
                dst.n = int(src.n[i])
                dst.mean = float(src.mean[i])
                dst.m_up = float(src.m_up[i])
                dst.m_dn = float(src.m_dn[i])
                dst.min_up = float(src.min_up[i])
                dst.max_dn = float(src.max_dn[i])
            t.round = int(self.round[i])
            t.switch_count = int(self.switch_count[i])
            t.prev_switched = bool(self.prev_switched[i])
            if not np.isnan(self.prev_action[i]):
                t.prev_action = float(self.prev_action[i])
                t.prev_context = self.prev_context[i].copy()


def stackable(policies: Sequence[object]) -> bool:
    """True when ``StackedAGFT.from_tuners`` would accept the fleet."""
    probe = StackedAGFT.from_tuners(policies, record_history=False)
    return probe is not None
