"""EDP-based reward (paper §4.2 "Reward Calculation"): r_t inversely
proportional to the window's measured EDP, with SLO pressure penalties.

Normalization: the first windows establish a reference EDP (EMA), so
r = -EDP/EDP_ref sits near -1 at baseline behaviour. That gives the
pruning thresholds their paper semantics (extreme pruning at mean reward
< -1.2 == ">=20% worse than reference").
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.energy.edp import WindowStats


@dataclasses.dataclass
class RewardConfig:
    warmup_windows: int = 5          # windows used to seed the reference
    ema: float = 0.02                # slow reference drift (non-stationarity)
    # TPOT SLO: ~1.33x the baseline TPOT of the reference serving setup
    # (llama3-3b @ A6000). 0 disables the penalty.
    slo_tpot_s: float = 0.016
    slo_penalty: float = 2.0
    # TTFT weight in the window-EDP delay (aligns the online objective with
    # the offline sweep's delay mix; 0 reverts to pure TPOT delay)
    # 0.1 balances offline-objective alignment (Tab 6) against stability
    # under non-stationary traces (0.25 aligns prototypes better but the
    # noisier TTFT signal destabilizes the Azure longrun — measured)
    ttft_weight: float = 0.1
    queue_penalty: float = 0.05      # per unit of waiting/running pressure
    # Switching-cost awareness (arXiv:2410.11855 switching-aware bandits):
    # a DVFS transition is priced as `switch_cost_j` extra joules folded
    # into the window's EDP whenever the credited action CHANGED the
    # frequency. 0 (default) reproduces the paper's switching-oblivious
    # reward exactly; the ``agft-switchcost`` registry variant enables it.
    switch_cost_j: float = 0.0


class RewardCalculator:
    def __init__(self, cfg: RewardConfig = RewardConfig()):
        self.cfg = cfg
        self.ref_edp: Optional[float] = None
        self.windows_seen = 0

    def __call__(self, w: WindowStats, switched: bool = False) -> float:
        """Reward for the window; ``switched`` marks that the credited
        action was a frequency *change* (a DVFS transition happened at the
        window's start), billing ``switch_cost_j`` into its energy."""
        self.windows_seen += 1
        if switched and self.cfg.switch_cost_j:
            w = dataclasses.replace(
                w, energy_j=w.energy_j + self.cfg.switch_cost_j)
        edp = max(w.edp_mixed(self.cfg.ttft_weight), 1e-12)
        if self.ref_edp is None:
            self.ref_edp = edp
        elif self.windows_seen <= self.cfg.warmup_windows:
            self.ref_edp += (edp - self.ref_edp) / self.windows_seen
        else:
            self.ref_edp += self.cfg.ema * (edp - self.ref_edp)
        r = -edp / max(self.ref_edp, 1e-12)
        if (self.cfg.slo_tpot_s > 0
                and w.effective_tpot > self.cfg.slo_tpot_s):
            r -= self.cfg.slo_penalty * (
                w.effective_tpot / self.cfg.slo_tpot_s - 1.0)
        if w.requests_waiting > 0 and w.requests_running > 0:
            r -= self.cfg.queue_penalty * min(
                w.requests_waiting / max(w.requests_running, 1), 2.0)
        return r
