"""Intelligent action-space pruning (paper §4.3, Fig. 9): three cooperating
mechanisms that shrink the frequency action space so exploration
concentrates on viable regions.

1. Extreme-frequency instant pruning — early-rounds hard filter: an arm
   whose mean reward is catastrophically bad (below a hard negative
   threshold after a minimum number of samples) is removed permanently.
2. Historical performance pruning — mature-phase statistical filter: an arm
   sufficiently sampled whose mean EDP trails the best arm's by more than a
   dynamic tolerance (std of arm means) is removed.
3. Cascade pruning — physical heuristic: when a pruned frequency lies below
   half of f_max, every lower frequency is pruned with it (if a moderate
   clock already can't keep up, slower clocks certainly can't).

Under a fleet-assigned frequency band (``LinUCBBank.set_band``, see
``repro.policies.hierarchy``) pruning additionally never removes the last
band-legal arm: pruning is permanent, the band is not, so destroying the
only in-band action would leave the coordinator nothing to govern. With no
band set every arm is legal and the guard is inert.

All three mechanisms also apply to 2-D ``(f_prefill, f_decode)`` action
spaces (``repro.core.tuner2d``): extreme and historical pruning are
key-agnostic (they read per-arm reward/EDP statistics), and the cascade
generalizes axis-wise — a pair pruned with both clocks in the slow half
drags down every pair it dominates on both axes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Set

import numpy as np

from repro_torch.core.linucb import LinUCBBank


@dataclasses.dataclass
class PruningConfig:
    enabled: bool = True
    # extreme pruning
    early_rounds: int = 60
    extreme_min_samples: int = 3
    extreme_reward_threshold: float = -1.2
    # historical pruning
    mature_rounds: int = 30
    historical_min_samples: int = 6
    historical_tolerance_k: float = 1.0   # tolerance = k * std(mean EDPs)
    # cascade pruning
    cascade_fraction_of_fmax: float = 0.5
    # never shrink below this many arms
    min_arms: int = 3


class PruningFramework:
    def __init__(self, cfg: PruningConfig, f_max: float):
        self.cfg = cfg
        self.f_max = f_max
        self.permanently_pruned: Set[float] = set()
        self.log: List[dict] = []

    # ------------------------------------------------------------------
    def _prune(self, bank: LinUCBBank, f: float, mechanism: str,
               round_idx: int) -> None:
        if bank.is_legal(f) and bank.n_legal() <= 1:
            return                    # never orphan the band (see module doc)
        bank.remove(f)
        self.permanently_pruned.add(f)
        self.log.append({"round": round_idx, "freq": f,
                         "mechanism": mechanism})

    def _cascade(self, bank: LinUCBBank, f: float, round_idx: int) -> None:
        frac = self.cfg.cascade_fraction_of_fmax * self.f_max
        if isinstance(f, tuple):
            # 2-D actions: the physical argument generalizes axis-wise —
            # if a pair with BOTH clocks in the slow half can't keep up,
            # any pair it dominates (no faster on either axis) can't
            # either. Pairs with one fast axis never trigger a cascade.
            if f[0] >= frac or f[1] >= frac:
                return
            for g in list(bank.frequencies):
                if (g[0] <= f[0] and g[1] <= f[1]
                        and len(bank.arms) > self.cfg.min_arms):
                    self._prune(bank, g, "cascade", round_idx)
            return
        if f >= frac:
            return
        for g in list(bank.frequencies):
            if g < f and len(bank.arms) > self.cfg.min_arms:
                self._prune(bank, g, "cascade", round_idx)

    # ------------------------------------------------------------------
    def apply(self, bank: LinUCBBank, round_idx: int) -> None:
        """Arm statistics are read through ``bank.arm_stats()`` — one
        vectorized snapshot per phase instead of thousands of per-arm view
        resolutions. The snapshot is exact: removals never change the
        surviving arms' sufficient statistics, so values read up front
        equal the per-iteration live reads of the original walk."""
        if not self.cfg.enabled:
            return
        cfg = self.cfg
        arms = bank.arms
        # 1. extreme instant pruning (early phase only)
        if round_idx <= cfg.early_rounds:
            for f, n, mr, _ in bank.arm_stats():
                if len(arms) <= cfg.min_arms:
                    break
                if (n >= cfg.extreme_min_samples
                        and mr < cfg.extreme_reward_threshold):
                    self._prune(bank, f, "extreme", round_idx)
                    self._cascade(bank, f, round_idx)
        # 2. historical performance pruning (mature phase)
        if round_idx >= cfg.mature_rounds:
            sampled = [(f, me) for f, n, _, me in bank.arm_stats()
                       if n >= cfg.historical_min_samples]
            if len(sampled) >= 2:
                means = np.array([me for _, me in sampled])
                best = float(means.min())
                tol = cfg.historical_tolerance_k * float(means.std())
                for f, me in sampled:
                    if len(arms) <= cfg.min_arms:
                        break
                    if me > best + tol and me > best * 1.05:
                        self._prune(bank, f, "historical", round_idx)
                        self._cascade(bank, f, round_idx)

    def filter_candidates(self, freqs: List[float]) -> List[float]:
        """Refinement must not resurrect permanently-pruned frequencies."""
        return [f for f in freqs if f not in self.permanently_pruned]
