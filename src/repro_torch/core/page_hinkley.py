"""Page-Hinkley test + convergence detection (paper §4.2 "Exploitation
Phase": the system transitions to greedy exploitation once the reward
sequence stabilizes, detected via a Page-Hinkley test).

PH tracks the cumulative deviation of the reward from its running mean; a
drift alarm means the reward distribution shifted (workload regime change).
Convergence = enough rounds with NO alarm and low recent reward variance.
A post-convergence alarm re-opens exploration — the mechanism that keeps
AGFT adaptive under the Azure trace's non-stationarity.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque


class PageHinkley:
    """Two-sided Page-Hinkley change detector."""

    def __init__(self, delta: float = 0.005, threshold: float = 0.5,
                 min_samples: int = 10):
        self.delta = delta
        self.threshold = threshold
        self.min_samples = min_samples
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.mean = 0.0
        self.m_up = 0.0      # cumulative positive deviation statistic
        self.m_dn = 0.0
        self.min_up = 0.0
        self.max_dn = 0.0

    def update(self, value: float) -> bool:
        """Feed one observation; True => drift alarm."""
        self.n += 1
        self.mean += (value - self.mean) / self.n
        dev = value - self.mean
        self.m_up += dev - self.delta
        self.m_dn += dev + self.delta
        self.min_up = min(self.min_up, self.m_up)
        self.max_dn = max(self.max_dn, self.m_dn)
        if self.n < self.min_samples:
            return False
        up_alarm = (self.m_up - self.min_up) > self.threshold
        dn_alarm = (self.max_dn - self.m_dn) > self.threshold
        if up_alarm or dn_alarm:
            self.reset()
            return True
        return False


@dataclasses.dataclass
class ConvergenceConfig:
    stable_rounds: int = 30          # PH-quiet rounds needed to declare
    std_window: int = 30             # rolling window for reward std
    std_threshold: float = 0.45      # max rolling std at convergence
    # PH sensitivity is matched to the observed window-reward noise
    # (std ~0.3 around -1): delta ~ noise/3, threshold ~ 6-7x delta.
    ph_delta: float = 0.1
    ph_threshold: float = 2.0
    # hysteresis: re-opening exploration after convergence requires a much
    # larger sustained drift than the stabilization test (otherwise ordinary
    # window noise keeps bouncing the system out of exploitation)
    drift_delta: float = 0.2
    drift_threshold: float = 6.0


class ConvergenceDetector:
    """Explore -> exploit transition + drift-triggered re-exploration."""

    def __init__(self, cfg: ConvergenceConfig = ConvergenceConfig()):
        self.cfg = cfg
        self.ph = PageHinkley(cfg.ph_delta, cfg.ph_threshold)
        self.ph_drift = PageHinkley(cfg.drift_delta, cfg.drift_threshold)
        self.recent: Deque[float] = collections.deque(maxlen=cfg.std_window)
        self.quiet_rounds = 0
        self.converged = False
        self.converged_round = None
        self.first_converged_round = None
        self.reopened = 0                # drift-triggered re-explorations
        self.round = 0

    def rolling_std(self) -> float:
        if len(self.recent) < 2:
            return float("inf")
        import numpy as np
        return float(np.std(self.recent))

    def update(self, reward: float) -> bool:
        """Feed a reward; returns current converged state."""
        self.round += 1
        self.recent.append(reward)
        if self.converged:
            if self.ph_drift.update(reward):
                # genuine regime change: reopen exploration
                self.converged = False
                self.converged_round = None
                self.quiet_rounds = 0
                self.reopened += 1
                self.ph.reset()
            return self.converged
        drift = self.ph.update(reward)
        self.quiet_rounds = 0 if drift else self.quiet_rounds + 1
        if (self.quiet_rounds >= self.cfg.stable_rounds
                and self.rolling_std() <= self.cfg.std_threshold):
            self.converged = True
            self.converged_round = self.round
            if self.first_converged_round is None:
                self.first_converged_round = self.round
            self.ph_drift.reset()
        return self.converged
