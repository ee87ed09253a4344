"""Fleet-scope power policies: one controller, many engines.

The ROADMAP's cross-node coordination baseline: a cluster-global
controller that sets a SINGLE frequency for every node, driven by
fleet-aggregated telemetry — the thing to beat for per-node closed loops
(which can converge to different per-node optima under segregated
traffic). GreenLLM-style SLO budgeting and the paper's AGFT loop both
slot in unchanged as the *inner* decision rule, because the fleet is
exposed to them through :class:`FleetTelemetryView` — an aggregate-engine
facade satisfying the same ``clock``/``metrics.snapshot()``/
``set_frequency`` surface a single engine offers, with counters summed
across nodes (:func:`repro_torch.core.monitor.aggregate_snapshots`).

Fleet policies declare ``scope = "fleet"`` and implement
``act(engines, now)``; the event loop (``repro_torch.serving.driver``) calls
them on FLEET_TICK events every ``sampling_period_s`` sim-seconds, where
``now`` is the loop's coherent virtual time across all nodes. Attach via
``ServingCluster(..., fleet_policy="global")``.
"""
from __future__ import annotations

from typing import List, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.monitor import aggregate_snapshots
from repro_torch.energy.power_model import HardwareSpec
from repro_torch.policies.registry import get_policy, register_policy


@runtime_checkable
class FleetPolicy(Protocol):
    """Structural interface of a cluster-global frequency controller."""

    #: FLEET_TICK cadence in sim-seconds
    sampling_period_s: float

    def act(self, engines, now: float) -> Optional[float]:
        """Observe the fleet (aggregate telemetry only) and optionally set
        every engine's frequency; return the actuated frequency, else
        ``None``."""
        ...


class _AggregateMetrics:
    """``metrics.snapshot()`` shim summing every engine's exporter."""

    def __init__(self, engines):
        self._engines = engines

    def snapshot(self):
        return aggregate_snapshots([e.metrics.snapshot()
                                    for e in self._engines])


class FleetTelemetryView:
    """Aggregate-engine facade: looks like one engine, is the whole fleet.

    ``clock`` is the event loop's virtual time (set by the fleet policy at
    each tick), ``metrics.snapshot()`` sums the nodes' counters, and
    ``set_frequency`` broadcasts — so any per-node policy (AGFT, SLO,
    ondemand, static) governs the fleet unmodified. Unknown attributes
    delegate to the first engine (model/engine config for analytic
    sweeps), which is sound for the homogeneous fleets ``ServingCluster``
    builds.
    """

    def __init__(self, engines):
        self.engines = list(engines)
        self.clock = 0.0
        self.metrics = _AggregateMetrics(self.engines)

    @property
    def frequency(self) -> float:
        return float(np.mean([e.frequency for e in self.engines]))

    def set_frequency(self, f_mhz: float) -> None:
        for e in self.engines:
            e.set_frequency(f_mhz)

    def __getattr__(self, name):
        return getattr(self.engines[0], name)


@register_policy("global")
class GlobalFrequencyPolicy:
    """Fleet-wide single-frequency controller (cross-node baseline).

    Wraps an *inner* per-node-style policy (registry name or instance;
    default the paper's ``agft`` tuner) and runs it against the
    :class:`FleetTelemetryView`, so one closed loop learns one frequency
    for the whole cluster from summed telemetry::

        get_policy("global")                          # global AGFT
        get_policy("global", inner="slo")             # global SLO budget
        get_policy("global", inner="static", frequency_mhz=1200.0)

    Extra kwargs construct the inner policy. Compare against
    ``ServingCluster(policies=["agft", ...])`` on the same trace to
    quantify what per-node loops buy (``benchmarks.tab_fleet``).
    """

    scope = "fleet"

    def __init__(self, hardware: HardwareSpec, inner="agft",
                 sampling_period_s: float = 0.8, **inner_kwargs):
        # fleet-policy registry convention: ``hardware`` may be a per-node
        # spec list on mixed fleets; a single global frequency is governed
        # against the primary (first) spec
        if not isinstance(hardware, HardwareSpec):
            hardware = list(hardware)[0]
        if isinstance(inner, str):
            inner = get_policy(inner, hardware=hardware,
                               sampling_period_s=sampling_period_s,
                               **inner_kwargs)
        elif inner_kwargs:
            raise TypeError("inner_kwargs only apply when `inner` is a "
                            "registry name")
        self.hw = hardware
        self.inner = inner
        self.sampling_period_s = sampling_period_s
        self.view: Optional[FleetTelemetryView] = None

    # ------------------------------------------------------------------
    def act(self, engines, now: float) -> Optional[float]:
        if self.view is None or self.view.engines != list(engines):
            self.view = FleetTelemetryView(engines)
        self.view.clock = now
        return self.inner.maybe_act(self.view)

    def maybe_act(self, engine) -> Optional[float]:
        raise TypeError(
            "GlobalFrequencyPolicy is fleet-scope: attach it with "
            "ServingCluster(..., fleet_policy=...), not as a per-node "
            "policy")

    # ------------------------------------------------------------------
    @property
    def history(self) -> List[dict]:
        """Per-window decision history, recorded by the inner policy."""
        return self.inner.history
