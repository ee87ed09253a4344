"""Reactive rule-based governors: utilization-threshold DVFS and an
SLO-aware latency feedback controller.

These are the competing controllers the paper's evaluation is implicitly
measured against: ``ondemand`` is the classic OS governor (scales with raw
utilization, blind to the serving phase mix), ``slo`` is a GreenLLM-style
(arXiv:2508.16449) TPOT-budget controller — minimize frequency subject to
a latency budget, with AIMD dynamics (additive down-steps while the budget
has headroom, multiplicative recovery on violation).

Both are band-governable (``WindowedPolicy.set_band``): under a
hierarchical power-cap coordinator their decisions — including ondemand's
jump-to-f_max and the SLO controller's multiplicative boost — are clamped
into the fleet-assigned ``[f_lo, f_hi]``; the band's upper edge wins over
latency recovery because the cap is a hard datacenter constraint.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.energy.power_model import HardwareSpec
from repro_torch.policies.base import WindowedPolicy
from repro_torch.policies.fixed import snap_to_grid
from repro_torch.policies.registry import register_policy


@register_policy("ondemand")
class OndemandPolicy(WindowedPolicy):
    """Linux-ondemand-style governor on the telemetry window.

    util = busy_s / window duration. Above ``up_threshold`` jump straight
    to f_max; below it scale the target proportionally (f_max * util /
    up_threshold). Phase-blind by construction: a fully-busy memory-bound
    decode window looks identical to a compute-bound prefill window, so it
    never finds the interior EDP optimum — exactly the failure mode that
    motivates AGFT.
    """

    phase_name = "ondemand"

    def __init__(self, hardware: HardwareSpec,
                 up_threshold: float = 0.8,
                 sampling_period_s: float = 0.8):
        super().__init__(hardware, sampling_period_s)
        self.up_threshold = up_threshold

    def decide(self, window, engine) -> Optional[float]:
        if window is None:
            return self.hw.f_max
        util = window.busy_s / max(window.duration_s, 1e-9)
        if util >= self.up_threshold:
            return self.hw.f_max
        return snap_to_grid(self.hw.f_max * util / self.up_threshold,
                            self.hw)


@register_policy("slo")
class SLOAwareLatencyPolicy(WindowedPolicy):
    """Latency-budget feedback controller (GreenLLM-style), in one of two
    budget modes:

    ``mode="tpot"`` (default) tracks the window's effective TPOT;
    ``mode="ttft"`` tracks the window's mean first-token latency, measured
    from the scheduler's exact first-token counters (no float-equality
    replay) — the budget that matters for interactive front-ends whose
    SLO is on responsiveness rather than streaming rate.

    Either way the controller walks the frequency down while the budgeted
    latency has headroom and recovers multiplicatively on violation
    (latency safety beats energy). The budget is either given explicitly
    (``tpot_slo_s`` / ``ttft_slo_s``) or self-calibrated as ``(1 +
    overhead_budget)`` x the first productive window's value at the
    initial (default f_max) frequency — i.e. "spend at most the paper's
    <10% latency overhead".
    """

    phase_name = "slo"

    def __init__(self, hardware: HardwareSpec,
                 tpot_slo_s: Optional[float] = None,
                 overhead_budget: float = 0.10,
                 headroom: float = 0.9,
                 down_step_mhz: Optional[float] = None,
                 boost: float = 1.25,
                 sampling_period_s: float = 0.8,
                 mode: str = "tpot",
                 ttft_slo_s: Optional[float] = None):
        if mode not in ("tpot", "ttft"):
            raise ValueError(f"mode must be 'tpot' or 'ttft', got {mode!r}")
        super().__init__(hardware, sampling_period_s)
        self.mode = mode
        self.tpot_slo_s = tpot_slo_s
        self.ttft_slo_s = ttft_slo_s
        self.overhead_budget = overhead_budget
        self.headroom = headroom
        self.down_step_mhz = down_step_mhz or 2 * hardware.f_step
        self.boost = boost

    # ------------------------------------------------------------------
    def _budgeted_latency(self, window) -> Optional[float]:
        """The window's value of the budgeted metric, or None if the
        window produced no samples of it."""
        if self.mode == "ttft":
            # mean_ttft_s is 0 when no request produced its first token
            # in this window — no signal, no decision
            return window.mean_ttft_s if window.mean_ttft_s > 0 else None
        if window.generation_tokens <= 0:
            return None
        return window.effective_tpot

    def _budget(self) -> Optional[float]:
        return self.ttft_slo_s if self.mode == "ttft" else self.tpot_slo_s

    def _calibrate(self, value: float) -> None:
        budget = value * (1.0 + self.overhead_budget)
        if self.mode == "ttft":
            self.ttft_slo_s = budget
        else:
            self.tpot_slo_s = budget

    def decide(self, window, engine) -> Optional[float]:
        if window is None:
            return None
        lat = self._budgeted_latency(window)
        if lat is None:
            return None
        budget = self._budget()
        if budget is None:
            # calibrate the budget off the reference window and hold
            self._calibrate(lat)
            return None
        f = engine.frequency
        if lat > budget:
            # violation: multiplicative recovery (at least two grid steps)
            return snap_to_grid(max(f * self.boost,
                                    f + 2 * self.hw.f_step), self.hw)
        if lat < self.headroom * budget:
            # headroom: additive decrease toward the energy-optimal floor
            return snap_to_grid(f - self.down_step_mhz, self.hw)
        return None


@register_policy("slo-ttft")
def make_slo_ttft(hardware: HardwareSpec, **kwargs
                  ) -> SLOAwareLatencyPolicy:
    """TTFT-budget convenience entry: ``get_policy("slo-ttft")`` ==
    ``get_policy("slo", mode="ttft")``. A redundant ``mode="ttft"`` kwarg
    is tolerated; any other mode is rejected."""
    mode = kwargs.pop("mode", "ttft")
    if mode != "ttft":
        raise ValueError(f"slo-ttft is fixed to mode='ttft', got {mode!r}")
    return SLOAwareLatencyPolicy(hardware, mode="ttft", **kwargs)
