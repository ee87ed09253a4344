"""Fixed-frequency policies: static pinning and the offline-oracle fix.

``StaticPolicy`` is the classic "locked clocks" baseline (nvidia-smi -lgc).
``OracleFixedPolicy`` is the paper's "theoretical optimum" comparator: the
best *fixed* frequency from an offline EDP sweep. Pass the swept value in
(e.g. from ``benchmarks.common.two_stage_optimal``); when none is given it
sweeps the hardware grid analytically with the engine's own DVFS cost
model over a representative mixed continuous-batching iteration.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.energy.costs import iteration_cost
from repro_torch.energy.power_model import DVFSModel, HardwareSpec
from repro_torch.policies.base import WindowedPolicy
from repro_torch.policies.registry import register_policy


def snap_to_grid(f_mhz: float, hw: HardwareSpec) -> float:
    """Clamp to the envelope and round onto the native frequency grid."""
    f = min(max(f_mhz, hw.f_min), hw.f_max)
    steps = round((f - hw.f_min) / hw.f_step)
    return min(hw.f_min + steps * hw.f_step, hw.f_max)


@register_policy("static")
class StaticPolicy(WindowedPolicy):
    """Pin one frequency for the whole run.

    Default is 0.7 x f_max snapped to the grid — inside the band where the
    paper's offline optima land (Fig. 6: 1200-1410 of 1800 MHz).
    """

    phase_name = "static"

    def __init__(self, hardware: HardwareSpec,
                 frequency_mhz: Optional[float] = None,
                 sampling_period_s: float = 0.8):
        super().__init__(hardware, sampling_period_s)
        self.frequency_mhz = snap_to_grid(
            frequency_mhz if frequency_mhz is not None
            else 0.7 * hardware.f_max, hardware)

    def decide(self, window, engine):
        return self.frequency_mhz


@register_policy("oracle")
class OracleFixedPolicy(StaticPolicy):
    """Best fixed frequency from an offline sweep.

    With an explicit ``frequency_mhz`` (measured sweep optimum) this is a
    relabelled StaticPolicy. Without one it runs the sweep analytically on
    first contact with the engine: per-iteration EDP = P(f) * t(f)^2 over
    the full frequency grid, priced by the engine backend's DVFS model on a
    decode-dominant mixed iteration (``decode_frac`` of the seq budget
    decoding at ``avg_context``, one prefill chunk in flight).
    """

    phase_name = "oracle"

    def __init__(self, hardware: HardwareSpec,
                 frequency_mhz: Optional[float] = None,
                 sampling_period_s: float = 0.8,
                 decode_frac: float = 0.5, avg_context: float = 1024.0,
                 prefill_chunk: int = 256):
        WindowedPolicy.__init__(self, hardware, sampling_period_s)
        self.frequency_mhz = (snap_to_grid(frequency_mhz, hardware)
                              if frequency_mhz is not None else None)
        self.decode_frac = decode_frac
        self.avg_context = avg_context
        self.prefill_chunk = prefill_chunk

    def decide(self, window, engine):
        if self.frequency_mhz is None:
            self.frequency_mhz = self._sweep(engine)
        return self.frequency_mhz

    def _sweep(self, engine) -> float:
        cfg = engine.model_cfg
        dvfs = getattr(engine.backend, "dvfs", None) or DVFSModel(self.hw)
        decode_seqs = max(int(self.decode_frac * engine.cfg.max_num_seqs), 1)
        fd, md = iteration_cost(cfg, prefill_tokens=0,
                                decode_seqs=decode_seqs,
                                avg_context=self.avg_context)
        fp, mp = iteration_cost(cfg, prefill_tokens=self.prefill_chunk,
                                decode_seqs=0,
                                avg_context=self.prefill_chunk / 2)
        flops, mem = fd + fp, md + mp
        # under a fleet-assigned band, sweep inside it: the in-band EDP
        # optimum generally differs from the unconstrained optimum clamped
        # to the band edge (a grid-free band falls back to the base clamp)
        grid = self.hw.frequencies()
        if self.band is not None:
            in_band = [f for f in grid
                       if self.band[0] - 1e-9 <= f <= self.band[1] + 1e-9]
            grid = in_band or grid
        best_f, best_edp = self.hw.f_max, float("inf")
        for f in grid:
            t, p = dvfs.iteration_time_power(flops, mem, f)
            edp = p * t * t
            if edp < best_edp:
                best_f, best_edp = f, edp
        return float(best_f)
