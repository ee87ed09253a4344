"""AGFT-2D: phase-disaggregated AGFT over a pruned product action space.

The 1-D tuner (``repro_torch.core.tuner``) learns one clock per node; this
subclass learns a PAIR ``(f_prefill, f_decode)`` and actuates it through
``engine.set_phase_frequencies`` — prefill-chunk work runs at the first
clock, pure-decode work at the second, mixed iterations price each half at
its own clock with every phase switch billed through the engine's DVFS
transition machinery (GreenLLM, arXiv:2508.16449: prefill is compute-bound,
decode bandwidth-bound, so the two optima are hundreds of MHz apart).

The full product of two hardware grids (~107 x 107 actions on an A6000) is
unlearnable inside a sub-second-window run, so the initial space is a
PRUNED product: each axis is seeded around its analytic per-phase EDP
optimum (``repro_torch.energy.phase_optimal_frequencies`` — the same sweep the
``greenllm-rule`` comparator pins statically) with ``2*seed_span + 1``
points at ``seed_step_mhz`` spacing, giving a 5x5 = 25-pair space by
default. From there the 1-D machinery generalizes: the LinUCB bank keys
arms by pair (lexicographic deterministic order), pruning's cascade drops
axis-dominated slow pairs, refinement rebuilds a product grid around the
anchor pair, and ``set_band`` masks pairs with EITHER clock out of band so
hierarchy/thermal clamps compose.

Everything else — features, reward, Page-Hinkley convergence, telemetry
windows, fault-aware freezes — is inherited unchanged. The seeding sweep
needs the engine's model/scheduler shape, so the bank is built lazily on
first contact; construction stays registry-compatible
(``get_policy("agft-2d")``).

Batched fleet mode (``step_mode="batched"``) refuses phased policies at
construction: its vectorized pricing paths are single-clock per node.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.linucb import LinUCBBank
from repro_torch.core.tuner import AGFTConfig, AGFTTuner
from repro_torch.energy.phases import phase_optimal_frequencies
from repro_torch.energy.power_model import HardwareSpec

import numpy as np


class AGFT2DTuner(AGFTTuner):
    #: feature-detected by the batched fleet loop's construction guard
    #: (phase-disaggregated actuation needs the per-event engine path)
    phased = True

    def __init__(self, hardware: HardwareSpec,
                 cfg: Optional[AGFTConfig] = None, *,
                 seed_span: int = 2, seed_step_mhz: float = 90.0,
                 batch_cap: Optional[int] = None):
        super().__init__(hardware, cfg)
        self.seed_span = int(seed_span)
        self.seed_step_mhz = float(seed_step_mhz)
        #: optional second knob: clamp the scheduler's concurrent-seq
        #: admission (``ContinuousBatchingScheduler.set_admission_cap``)
        self.batch_cap = batch_cap
        #: the product space is seeded from the engine's own model and
        #: scheduler shape, so it is built on first contact; until then
        #: the inherited 1-D bank is a placeholder that never selects
        self._space_built = False
        self.seed_pair: Optional[Tuple[float, float]] = None

    # ------------------------------------------------------------------
    def _snap(self, f: float) -> float:
        hw = self.hw
        f = min(max(f, hw.f_min), hw.f_max)
        return min(hw.f_min + round((f - hw.f_min) / hw.f_step) * hw.f_step,
                   hw.f_max)

    def _axis(self, center: float) -> list:
        return sorted({self._snap(center + k * self.seed_step_mhz)
                       for k in range(-self.seed_span, self.seed_span + 1)})

    def _build_space(self, engine) -> None:
        dvfs = getattr(engine.backend, "dvfs", None)
        sched = getattr(engine, "sched", None)
        self.seed_pair = phase_optimal_frequencies(
            self.hw, engine.model_cfg, dvfs=dvfs,
            prefill_chunk=getattr(engine.cfg, "prefill_chunk", 512),
            decode_seqs=max(getattr(engine.cfg, "max_num_seqs", 64) // 2,
                            1))
        pairs = [(a, b) for a in self._axis(self.seed_pair[0])
                 for b in self._axis(self.seed_pair[1])]
        self.bank = LinUCBBank(pairs, dim=self.features.dim,
                               ridge=self.cfg.ridge)
        if self.band is not None:
            self.bank.set_band(*self.band)
        if self.batch_cap is not None and sched is not None:
            sched.set_admission_cap(self.batch_cap)
        self._space_built = True

    # ------------------------------------------------------------------
    def act(self, engine, now: Optional[float] = None):
        if not self._space_built:
            self._build_space(engine)
        return super().act(engine, now=now)

    def _diverged(self, engine) -> bool:
        # stuck/clamped actuation surfaces as the engine's phase targets
        # (or a scalar override clearing them) differing from the issued
        # pair
        return (self.prev_action is not None
                and getattr(engine, "freq_targets", None)
                != self.prev_action)

    def _actuate(self, engine, f, reward, window, phase,
                 x_t: Optional[np.ndarray] = None,
                 t: Optional[float] = None) -> None:
        pair = (f if isinstance(f, tuple) else (float(f), float(f)))
        engine.set_phase_frequencies(*pair)
        self.prev_switched = (self.prev_action is not None
                              and pair != self.prev_action)
        self.switch_count += int(self.prev_switched)
        self.prev_action = pair
        self.prev_context = (x_t if x_t is not None
                             else np.zeros(self.features.dim))
        self.history.append({
            "t": engine.clock if t is None else t,
            "freq": pair,
            "reward": reward,
            "edp": window.edp if window else None,
            "energy_j": window.energy_j if window else None,
            "tpot": window.effective_tpot if window else None,
            "phase": phase or "warmup",
            "n_arms": len(self.bank.arms),
            "converged": self.convergence.converged,
            "band": self.band,
        })
