"""Phase-disaggregated policies: the optional 2-D decision surface.

GreenLLM (arXiv:2508.16449) observes that the two phases of LLM inference
want different clocks — prefill is compute-bound (fast clocks amortize),
decode is bandwidth-bound (fast clocks burn power waiting on HBM) — so a
single per-node frequency is always a compromise. Policies here emit
``(f_prefill, f_decode)`` pairs instead: ``WindowedPolicy.tick`` clamps
both axes and actuates them via ``engine.set_phase_frequencies``, the
engine prices each iteration phase at its own clock and bills every
phase switch through the DVFS-transition machinery.

Two registry entries:

``greenllm-rule``  static per-phase targets from the offline analytic EDP
                   sweep (``repro_torch.energy.phase_optimal_frequencies``) —
                   the rule-based comparator: right clocks, no adaptation.
``agft-2d``        the learned counterpart (``repro_torch.core.tuner2d``): AGFT
                   over a pruned product action space seeded around the
                   same analytic optima.

Both declare ``phased = True`` — the batched fleet loop
(``repro_torch.serving.fleet_step``) refuses phased policies at construction
because its vectorized pricing is single-clock per node; use the event
loop (``step_mode="events"``).

``benchmarks/tab_phases_2d.py`` ablates 1-D AGFT vs both of these on the
Azure production trace.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.tuner import AGFTConfig
from repro_torch.core.tuner2d import AGFT2DTuner
from repro_torch.energy.phases import phase_optimal_frequencies
from repro_torch.energy.power_model import HardwareSpec
from repro_torch.policies.base import WindowedPolicy
from repro_torch.policies.registry import register_policy


@register_policy("agft-2d")
def make_agft_2d(hardware: HardwareSpec,
                 cfg: Optional[AGFTConfig] = None,
                 seed_span: int = 2, seed_step_mhz: float = 90.0,
                 batch_cap: Optional[int] = None,
                 **kwargs) -> AGFT2DTuner:
    """``get_policy("agft-2d")`` — phase-disaggregated AGFT. Extra kwargs
    are AGFTConfig fields; ``seed_span``/``seed_step_mhz`` shape the
    seeded product space (``2*span + 1`` points per axis), ``batch_cap``
    optionally clamps scheduler admission as a second knob."""
    if cfg is not None and kwargs:
        raise TypeError("pass either cfg= or AGFTConfig field kwargs")
    return AGFT2DTuner(hardware, cfg or AGFTConfig(**kwargs),
                       seed_span=seed_span, seed_step_mhz=seed_step_mhz,
                       batch_cap=batch_cap)


@register_policy("greenllm-rule")
class GreenLLMRulePolicy(WindowedPolicy):
    """Static per-phase clocks from the analytic EDP sweep.

    Decides the same ``(f_prefill, f_decode)`` pair every window: each
    phase's single-iteration EDP argmin over the hardware grid, computed
    lazily on first decision from the engine's own model/scheduler shape
    (and recomputed if a fleet coordinator moves the band, since the sweep
    is band-restricted). This is the oracle-flavored RULE comparator for
    the 2-D surface — the right clocks for each phase, but no adaptation
    to load, batch mix, or drift, which is exactly the gap ``agft-2d``
    is measured by.
    """

    phase_name = "greenllm"
    phased = True

    def __init__(self, hardware: HardwareSpec,
                 sampling_period_s: float = 0.8,
                 batch_cap: Optional[int] = None):
        super().__init__(hardware, sampling_period_s)
        self.batch_cap = batch_cap
        self._pair: Optional[Tuple[float, float]] = None
        self._pair_band = None

    def decide(self, window, engine):
        if self._pair is None or self._pair_band != self.band:
            self._pair = phase_optimal_frequencies(
                self.hw, engine.model_cfg,
                dvfs=getattr(engine.backend, "dvfs", None),
                prefill_chunk=getattr(engine.cfg, "prefill_chunk", 512),
                decode_seqs=max(
                    getattr(engine.cfg, "max_num_seqs", 64) // 2, 1),
                band=self.band)
            self._pair_band = self.band
            if self.batch_cap is not None and hasattr(engine, "sched"):
                engine.sched.set_admission_cap(self.batch_cap)
        return self._pair
