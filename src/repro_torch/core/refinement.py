"""Mixed maturity-based action-space refinement (paper §4.4, Fig. 10).

Periodically re-centers a fine-grained action space (anchor +/- 150 MHz at
15 MHz steps) around the current best estimate of the optimum:

* Statistical refinement (t < t_mature): anchor = lowest historical mean
  EDP among sufficiently-sampled arms — trust data, not the immature model.
* Predictive refinement (t >= t_mature): anchor = argmax LinUCB UCB score
  for the CURRENT context x_t — trust the mature model, focus exploration
  where it predicts the highest reward.

2-D ``(f_prefill, f_decode)`` action spaces (``repro.core.tuner2d``)
refine the same way with a product grid: per-axis windows centered on the
anchor pair (coarser range/step — ``half_range_2d_mhz``/``step_2d_mhz`` —
so the arm count stays learnable), filtered by the same permanent-prune
set and band rules.

Under a fleet-assigned frequency band (``repro.policies.hierarchy``) the
anchor is already band-restricted (both ``best_historical`` and
``argmax_ucb`` select among legal arms only) and the candidate grid is
clipped to the band before rebuilding — refinement concentrates arms
where the coordinator allows the node to act instead of spending them on
frequencies the mask would immediately veto. A band too narrow to hold 3
grid points skips refinement (the bank's nearest-arm guarantee keeps at
least one action legal).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.linucb import LinUCBBank
from repro_torch.core.pruning import PruningFramework


@dataclasses.dataclass
class RefinementConfig:
    enabled: bool = True
    interval: int = 25               # rounds between refinements
    maturity_threshold: int = 100    # t_mature
    stat_min_samples: int = 4
    half_range_mhz: float = 150.0
    step_mhz: float = 15.0
    # 2-D (f_prefill, f_decode) action spaces refine on a coarser product
    # grid per axis so arm count stays learnable (default 5x5 = 25 arms
    # per refinement vs the 1-D grid's 21)
    half_range_2d_mhz: float = 90.0
    step_2d_mhz: float = 45.0


class MixedMaturityRefinement:
    def __init__(self, cfg: RefinementConfig, f_min: float, f_max: float,
                 ucb_alpha: float = 1.0):
        self.cfg = cfg
        self.f_min = f_min
        self.f_max = f_max
        self.ucb_alpha = ucb_alpha
        self.log: List[dict] = []
        # anchor -> grid memo: refinement re-anchors on the same few
        # frequencies for most of a long run, and the grid is a pure
        # function of the anchor (callers never mutate the list)
        self._grid_cache: dict = {}

    # ------------------------------------------------------------------
    def _axis_grid(self, anchor: float, half_range: float,
                   step: float) -> List[float]:
        lo = max(self.f_min, anchor - half_range)
        hi = min(self.f_max, anchor + half_range)
        # np.float64 subclasses float, so round() on the tolist() floats
        # is the same float.__round__ the array elements would use
        grid = np.arange(lo, hi + 1e-9, step)
        return [round(f, 3) for f in grid.tolist()]

    def _candidate_grid(self, anchor) -> List[float]:
        cached = self._grid_cache.get(anchor)
        if cached is not None:
            return cached
        cfg = self.cfg
        if isinstance(anchor, tuple):
            # 2-D anchor: product of per-axis grids centered on the pair
            # (coarser per-axis range/step — see RefinementConfig)
            pf = self._axis_grid(anchor[0], cfg.half_range_2d_mhz,
                                 cfg.step_2d_mhz)
            de = self._axis_grid(anchor[1], cfg.half_range_2d_mhz,
                                 cfg.step_2d_mhz)
            out = [(a, b) for a in pf for b in de]
        else:
            out = self._axis_grid(anchor, cfg.half_range_mhz, cfg.step_mhz)
        self._grid_cache[anchor] = out
        return out

    def maybe_refine(self, bank: LinUCBBank, pruner: PruningFramework,
                     x_t: np.ndarray, round_idx: int,
                     anchor: Optional[float] = None) -> Optional[float]:
        """Returns the anchor if a refinement happened. ``anchor`` may carry
        a precomputed predictive anchor (the stacked fleet path batches the
        UCB argmax across due nodes); it must equal what
        ``bank.argmax_ucb(x_t, self.ucb_alpha)`` would return and is only
        consulted in the mature phase."""
        cfg = self.cfg
        if not cfg.enabled or round_idx == 0 or round_idx % cfg.interval:
            return None
        if round_idx < cfg.maturity_threshold:
            anchor = bank.best_historical(cfg.stat_min_samples)
            mode = "statistical"
            if anchor is None:
                return None
        else:
            if anchor is None:
                anchor = bank.argmax_ucb(x_t, self.ucb_alpha)
            mode = "predictive"
        grid = pruner.filter_candidates(self._candidate_grid(anchor))
        band = getattr(bank, "band", None)
        if band is not None:
            lo, hi = band[0] - 1e-9, band[1] + 1e-9
            if isinstance(anchor, tuple):
                # the band clips BOTH axes of a 2-D product grid
                grid = [f for f in grid
                        if lo <= f[0] <= hi and lo <= f[1] <= hi]
            else:
                grid = [f for f in grid if lo <= f <= hi]
        if len(grid) < 3:
            return None
        bank.rebuild(grid, warm_from=anchor)
        self.log.append({"round": round_idx, "anchor": anchor, "mode": mode,
                         "n_arms": len(grid)})
        return anchor
