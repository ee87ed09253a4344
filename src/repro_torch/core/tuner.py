"""AGFT: the closed-loop adaptive frequency tuner (paper §4, Fig. 8).

Wires the pieces together on the monitor's sampling cadence:
  metric snapshot -> WindowStats -> (reward for the PREVIOUS action,
  7-dim context x_t) -> LinUCB update -> pruning -> refinement ->
  action selection (UCB exploration / greedy exploitation, gated by the
  Page-Hinkley convergence detector) -> frequency actuation.

The tuner touches the engine ONLY through (a) the metrics snapshot —
windowed by the shared :class:`repro.core.monitor.TelemetryMonitor` — and
(b) ``set_frequency``, the non-invasive boundary the paper requires. It
conforms to the ``repro.policies.PowerPolicy`` protocol and is registered
in the policy registry as ``"agft"``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.features import FeatureExtractor, FeatureScales
from repro_torch.core.linucb import LinUCBBank
from repro_torch.core.monitor import TelemetryMonitor
from repro_torch.core.page_hinkley import ConvergenceConfig, ConvergenceDetector
from repro_torch.core.pruning import PruningConfig, PruningFramework
from repro_torch.core.refinement import MixedMaturityRefinement, RefinementConfig
from repro_torch.core.reward import RewardCalculator, RewardConfig
from repro_torch.energy.power_model import HardwareSpec


@dataclasses.dataclass
class AGFTConfig:
    sampling_period_s: float = 0.8         # paper: sub-second window
    ucb_alpha: float = 0.8
    ridge: float = 1.0
    # exploration strategy: "linucb" (paper) | "thompson" (extension)
    strategy: str = "linucb"
    thompson_nu: float = 0.3
    # initial action space: coarse sweep of the full range
    initial_step_mhz: float = 90.0
    # ablations
    fine_grained: bool = True              # False => "No-grain"
    # graceful degradation under fault injection (repro.serving.faults):
    # freeze bandit updates on faulted/stale telemetry windows, hold the
    # previous frequency, and re-issue actuations that diverged from
    # telemetry. False = the naive baseline that learns from corrupted
    # windows (benchmarks/tab_faults.py quantifies the difference).
    fault_aware: bool = True
    pruning: PruningConfig = dataclasses.field(default_factory=PruningConfig)
    refinement: RefinementConfig = dataclasses.field(
        default_factory=RefinementConfig)
    convergence: ConvergenceConfig = dataclasses.field(
        default_factory=ConvergenceConfig)
    reward: RewardConfig = dataclasses.field(default_factory=RewardConfig)
    scales: FeatureScales = dataclasses.field(default_factory=FeatureScales)


class AGFTTuner:
    #: PowerPolicy scope: governs one engine (fleet-scope policies in
    #: ``repro.policies.fleet`` declare ``scope = "fleet"``)
    scope = "node"

    def __init__(self, hardware: HardwareSpec,
                 cfg: Optional[AGFTConfig] = None):
        self.hw = hardware
        self.cfg = cfg or AGFTConfig()
        if not self.cfg.fine_grained:
            # "No-grain" ablation: coarse actions, no refinement
            self.cfg.refinement = dataclasses.replace(
                self.cfg.refinement, enabled=False)
            self.cfg.initial_step_mhz = max(self.cfg.initial_step_mhz, 120.0)

        self.features = FeatureExtractor(self.cfg.scales)
        freqs = list(np.arange(hardware.f_min, hardware.f_max + 1e-9,
                               self.cfg.initial_step_mhz))
        if hardware.f_max not in freqs:
            freqs.append(hardware.f_max)
        self.bank = LinUCBBank([float(f) for f in freqs],
                               dim=self.features.dim, ridge=self.cfg.ridge)
        self.pruner = PruningFramework(self.cfg.pruning, hardware.f_max)
        self.refiner = MixedMaturityRefinement(
            self.cfg.refinement, hardware.f_min, hardware.f_max,
            ucb_alpha=self.cfg.ucb_alpha)
        self.convergence = ConvergenceDetector(self.cfg.convergence)
        self.reward_calc = RewardCalculator(self.cfg.reward)

        # closed-loop state
        self.round = 0
        self.monitor = TelemetryMonitor(self.cfg.sampling_period_s)
        self.prev_action: Optional[float] = None
        self.prev_context: Optional[np.ndarray] = None
        self.prev_switched = False    # did actuating prev_action change f?
        self.switch_count = 0         # actual DVFS transitions actuated
        self.band: Optional[tuple] = None   # fleet-assigned [f_lo, f_hi]
        self.history: List[dict] = []

    # ------------------------------------------------------------------
    def set_band(self, f_lo: float, f_hi: float) -> None:
        """Fleet-coordinator hook (hierarchical power capping): restrict
        the action space to ``[f_lo, f_hi]`` by masking LinUCB arms outside
        the band. Inverted bounds are tolerated (swapped), the band is
        clamped to the hardware envelope, and masking is reversible — a
        later, wider band re-legalizes the arms with their learned
        statistics intact. With no band set, decisions are bit-identical
        to the uncoordinated tuner."""
        lo, hi = (float(f_lo), float(f_hi))
        if lo > hi:
            lo, hi = hi, lo
        lo = min(max(lo, self.hw.f_min), self.hw.f_max)
        hi = min(max(hi, self.hw.f_min), self.hw.f_max)
        self.band = (lo, hi)
        self.bank.set_band(lo, hi)

    # ------------------------------------------------------------------
    @property
    def converged(self) -> bool:
        return self.convergence.converged

    @property
    def converged_round(self):
        return self.convergence.converged_round

    @property
    def first_converged_round(self):
        return self.convergence.first_converged_round

    # ------------------------------------------------------------------
    def maybe_act(self, engine) -> Optional[float]:
        """PowerPolicy entrypoint: called after every engine step; acts when
        the sampling window has elapsed. Returns the chosen frequency when
        it acts."""
        if not self.monitor.due(engine):
            return None
        return self.act(engine)

    def tick(self, engine, now: float) -> float:
        """POLICY_TICK entrypoint (``policy_tick_mode="tick"``): one
        decision per wall-clock tick, the telemetry window cut at the
        tick's virtual time ``now`` instead of at an iteration boundary
        (the event loop owns the cadence; no due-gating here)."""
        return self.act(engine, now=now)

    def act(self, engine, now: Optional[float] = None) -> float:
        # fault surface (None on healthy engines — the zero-fault path
        # pays one attribute read and stays decision-identical)
        fs = (getattr(engine, "fault_state", None)
              if self.cfg.fault_aware else None)
        if fs is not None and fs.scrape_dropped(
                engine.clock if now is None else now):
            # telemetry dropout: the scrape failed, the window is blank.
            # Re-arm the monitor without snapshotting (the next success
            # spans the gap) and hold the last safe frequency — no
            # context, no reward, nothing for the bandit to learn from.
            self.monitor.skip(engine, now=now)
            return self._fault_hold(engine, None, t=now)
        w_start = self.monitor.prev_time
        window = self.monitor.observe(engine, now=now)
        if window is None:
            # first observation: the monitor armed the window; take the floor
            f0 = self.bank.select_ucb(np.zeros(self.features.dim),
                                      self.cfg.ucb_alpha)
            self._actuate(engine, f0, None, None, None, t=now)
            return f0

        if fs is not None and (fs.disrupted_since(w_start)
                               or self._diverged(engine)):
            # faulted/stale window: a crash, recovery, throttle flip, or
            # dropout touched it — or the actuator silently stuck and the
            # engine diverged from the issued frequency. Its telemetry
            # would poison the LinUCB statistics, so freeze: no credit,
            # no convergence step, no refinement; hold the previous
            # frequency (re-issuing it, which is the stuck-DVFS recovery)
            # and withhold the corrupted context from the next credit.
            return self._fault_hold(engine, window, t=now)

        x_t = self.features(window)

        # 1. credit the previous action (billing its DVFS transition, if
        # the reward config prices switches)
        reward = None
        if self.prev_action is not None and self.prev_context is not None:
            reward = self.reward_calc(window, switched=self.prev_switched)
            arm = self.bank.arms.get(self.prev_action)
            if arm is not None:
                arm.update(self.prev_context, reward, edp=window.edp)
            self.convergence.update(reward)
            self.round += 1

        # 2. prune, refine (refinement only while learning: once converged
        # the system is in pure exploitation and the action space is frozen;
        # a Page-Hinkley drift alarm reopens both)
        self.pruner.apply(self.bank, self.round)
        if not self.convergence.converged:
            self.refiner.maybe_refine(self.bank, self.pruner, x_t,
                                      self.round)

        # 3. select
        if self.convergence.converged:
            f = self.bank.select_greedy(x_t)
            phase = "exploit"
        elif self.cfg.strategy == "thompson":
            f = self.bank.select_thompson(x_t, self.cfg.thompson_nu)
            phase = "explore"
        else:
            f = self.bank.select_ucb(x_t, self.cfg.ucb_alpha)
            phase = "explore"

        # 4. actuate + bookkeeping (the monitor already re-armed the window)
        self._actuate(engine, f, reward, window, phase, x_t, t=now)
        return f

    # ------------------------------------------------------------------
    def _diverged(self, engine) -> bool:
        """Did the engine's actuated state silently diverge from the last
        issued action (stuck/clamped DVFS under fault injection)? The 2-D
        tuner overrides this to compare phase-target pairs."""
        return (self.prev_action is not None
                and engine.frequency != self.prev_action)

    def _fault_hold(self, engine, window, t: Optional[float] = None
                    ) -> float:
        """Graceful degradation on a faulted window: re-issue the previous
        action (safe hold — also the stuck-actuator recovery path), record
        a ``fault-hold`` history row, and clear ``prev_context`` so the
        bandit credits nothing that touched corrupted telemetry."""
        f = (self.prev_action if self.prev_action is not None
             else float(engine.frequency))
        self._actuate(engine, f, None, window, "fault-hold", None, t=t)
        self.prev_context = None
        return f

    def _actuate(self, engine, f: float, reward, window, phase,
                 x_t: Optional[np.ndarray] = None,
                 t: Optional[float] = None) -> None:
        engine.set_frequency(f)
        self.prev_switched = (self.prev_action is not None
                              and float(f) != self.prev_action)
        self.switch_count += int(self.prev_switched)
        self.prev_action = float(f)
        self.prev_context = (x_t if x_t is not None
                             else np.zeros(self.features.dim))
        self.history.append({
            "t": engine.clock if t is None else t,
            "freq": float(f),
            "reward": reward,
            "edp": window.edp if window else None,
            "energy_j": window.energy_j if window else None,
            "tpot": window.effective_tpot if window else None,
            "phase": phase or "warmup",
            "n_arms": len(self.bank.arms),
            "converged": self.convergence.converged,
            "band": self.band,
        })
