"""Telemetry monitor: the Prometheus-boundary observation window.

The paper's monitor (§4.1 "Periodic Metric Acquisition") polls the engine's
metrics endpoint on a fixed sampling period and differences consecutive
snapshots into per-window aggregates. That windowing used to live inside
``AGFTTuner.act``; it is policy-agnostic, so it lives here and every power
policy (AGFT, ondemand, SLO-aware, ...) observes the engine through the
same ``WindowStats`` boundary — aggregate counters only, never per-request
state (the privacy contract in ``serving.request``).

The monitor is duck-typed over its source: anything exposing ``clock`` and
``metrics.snapshot()`` works, which is how fleet-scope policies reuse it —
:class:`repro.policies.fleet.FleetTelemetryView` aggregates every node's
snapshot (via :func:`aggregate_snapshots`) behind the same interface, so a
cluster-global controller observes the fleet exactly the way a per-node
controller observes one engine.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.energy.edp import WindowStats, diff_snapshots

#: snapshot keys that are point-in-time *levels* shared across the fleet —
#: aggregated by averaging. Everything else (monotonic counters, additive
#: gauges like queue depths or power draw) sums across nodes.
_MEAN_KEYS = frozenset({"vllm:gpu_cache_usage_perc",
                        "vllm:current_frequency_mhz"})


def aggregate_snapshots(snaps: Sequence[Dict[str, float]]
                        ) -> Dict[str, float]:
    """Fold per-engine metric snapshots into one fleet-level snapshot.

    Counters and additive gauges (queue depths, watts) sum; fractional /
    frequency levels average. The result is shaped exactly like a single
    engine's ``snapshot()``, so ``diff_snapshots`` and every policy built
    on :class:`TelemetryMonitor` consume it unchanged.

    The fold is one numpy axis-0 reduction over an ``(n_nodes, n_keys)``
    matrix. Axis-0 reduction accumulates rows sequentially (numpy's
    pairwise summation applies along the contiguous inner axis only), so
    the totals are bit-identical to the historical per-key Python ``sum``
    at any fleet size.
    """
    if not snaps:
        return {}
    keys = list(snaps[0])
    mat = np.array([[s[k] for k in keys] for s in snaps], dtype=np.float64)
    tot = np.sum(mat, axis=0)
    n = len(snaps)
    return {k: (tot[i] / n if k in _MEAN_KEYS else tot[i])
            for i, k in enumerate(keys)}


class TelemetryMonitor:
    """Samples ``engine.metrics.snapshot()`` on a fixed cadence and diffs
    consecutive snapshots into :class:`WindowStats`.

    Usage::

        if monitor.due(engine):
            window = monitor.observe(engine)   # None on the first sample
    """

    def __init__(self, sampling_period_s: float = 0.8):
        self.sampling_period_s = sampling_period_s
        self.prev_snapshot: Optional[Dict[str, float]] = None
        self.prev_time = 0.0
        self.next_sample = 0.0

    def due(self, engine) -> bool:
        """True once the engine clock has crossed the next sample point."""
        return engine.clock >= self.next_sample

    def skip(self, engine, now: Optional[float] = None) -> None:
        """A scrape attempt failed (telemetry dropout, ``repro.serving.
        faults``): re-arm the sampling window WITHOUT taking a snapshot.
        ``prev_snapshot``/``prev_time`` are untouched, so the next
        successful ``observe`` spans the gap — one stale window covering
        both periods, which fault-aware policies refuse to learn from."""
        if now is None:
            now = engine.clock
        self.next_sample = now + self.sampling_period_s

    def observe(self, engine,
                now: Optional[float] = None) -> Optional[WindowStats]:
        """Snapshot now and return the window since the previous snapshot.

        Returns ``None`` on the first observation (no window exists yet);
        either way the sampling window is (re)armed from the current clock.

        ``now`` overrides the window's cut point (POLICY_TICK mode: the
        poller samples on its own wall-clock cadence, so windows span
        exact periods instead of ending wherever an iteration boundary
        happened to land). The snapshot itself is whatever the counters
        hold — an engine mid-long-iteration has already advanced past the
        tick, exactly like a real scrape racing the serving loop.
        """
        if now is None:
            now = engine.clock
        snap = engine.metrics.snapshot()
        window = None
        if self.prev_snapshot is not None:
            window = diff_snapshots(self.prev_snapshot, snap,
                                    max(now - self.prev_time, 1e-9))
        self.prev_snapshot = snap
        self.prev_time = now
        self.next_sample = now + self.sampling_period_s
        return window
