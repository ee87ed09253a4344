"""Per-phase analytic EDP optima: the seed of phase-disaggregated DVFS.

Prefill iterations are compute-bound (their EDP-vs-frequency minimum sits
near the perf knee, ~0.78 f_max), decode iterations are bandwidth-bound
(their minimum sits near the bandwidth knee, ~0.65 f_max) — so the best
*single* clock is a compromise between two optima that are hundreds of MHz
apart (GreenLLM, arXiv:2508.16449). This module sweeps the hardware grid
once per phase with the same :class:`repro_torch.energy.DVFSModel` physics the
engine bills, producing the static per-phase pair ``(f_prefill, f_decode)``
that (a) the ``greenllm-rule`` comparator pins for a whole run and (b) the
2-D AGFT tuner uses to seed its pruned product action space.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

from repro_torch.energy.costs import iteration_cost
from repro_torch.energy.power_model import DVFSModel, HardwareSpec
from repro_torch.models.common import ModelConfig


@lru_cache(maxsize=32)
def _dvfs_for(hw: HardwareSpec) -> DVFSModel:
    """One tabulated DVFSModel per spec — mixed fleets resolve per-phase
    optima for the same tier many times (one policy per node); rebuilding
    the full frequency-terms table each call is pure waste."""
    return DVFSModel(hw)


def _edp_argmin(dvfs: DVFSModel, flops: float, mem: float,
                grid: Sequence[float]) -> float:
    """Frequency minimizing per-iteration EDP = P(f) * t(f)^2 over ``grid``
    (the ``OracleFixedPolicy._sweep`` criterion, applied to one phase)."""
    best_f, best_edp = grid[-1], float("inf")
    for f in grid:
        t, p = dvfs.iteration_time_power(flops, mem, f)
        edp = p * t * t
        if edp < best_edp:
            best_f, best_edp = f, edp
    return float(best_f)


def phase_optimal_frequencies(
        hw: HardwareSpec, model_cfg: ModelConfig, *,
        dvfs: Optional[DVFSModel] = None,
        prefill_chunk: int = 512,
        decode_seqs: int = 32,
        avg_context: float = 1024.0,
        band: Optional[Tuple[float, float]] = None) -> Tuple[float, float]:
    """Analytic ``(f_prefill, f_decode)``: the EDP-optimal clock for a
    representative pure-prefill iteration (one ``prefill_chunk``-token
    chunk) and for a representative pure-decode iteration (``decode_seqs``
    sequences at ``avg_context`` mean context).

    With a fleet-assigned ``band`` the sweep is restricted to in-band grid
    points on BOTH axes (falling back to the full grid when the band holds
    no grid point), so hierarchy/thermal clamps compose the same way they
    do for the 1-D oracle sweep.

    The optima are per-spec by construction (the sweep runs over ``hw``'s
    own grid with ``hw``'s own knees); the cached result path below makes
    repeat lookups on mixed fleets O(1) per node.
    """
    if dvfs is None:
        if band is None:
            return _phase_optima_cached(hw, model_cfg, prefill_chunk,
                                        decode_seqs, avg_context)
        dvfs = _dvfs_for(hw)
    grid = hw.frequencies()
    if band is not None:
        in_band = [f for f in grid
                   if band[0] - 1e-9 <= f <= band[1] + 1e-9]
        grid = in_band or grid
    fp, mp = iteration_cost(model_cfg, prefill_tokens=prefill_chunk,
                            decode_seqs=0,
                            avg_context=prefill_chunk / 2)
    fd, md = iteration_cost(model_cfg, prefill_tokens=0,
                            decode_seqs=max(decode_seqs, 1),
                            avg_context=avg_context)
    return (_edp_argmin(dvfs, fp, mp, grid),
            _edp_argmin(dvfs, fd, md, grid))


@lru_cache(maxsize=256)
def _phase_optima_cached(hw: HardwareSpec, model_cfg: ModelConfig,
                         prefill_chunk: int, decode_seqs: int,
                         avg_context: float) -> Tuple[float, float]:
    return phase_optimal_frequencies(
        hw, model_cfg, dvfs=_dvfs_for(hw), prefill_chunk=prefill_chunk,
        decode_seqs=decode_seqs, avg_context=avg_context)
