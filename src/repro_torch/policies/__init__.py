"""Pluggable power policies: interchangeable GPU-frequency controllers.

Every controller implements the :class:`PowerPolicy` protocol — a single
``maybe_act(engine) -> Optional[float]`` hook the shared drive loop
(``repro_torch.serving.driver``) calls after each engine step. Policies observe
the engine exclusively through the Prometheus-boundary telemetry window
(:class:`repro_torch.core.monitor.TelemetryMonitor` -> ``WindowStats``) and
actuate exclusively through ``engine.set_frequency`` — the paper's
non-invasive contract, now enforced for *all* baselines so comparisons
(paper Tables 2/3, GreenLLM-style SLO control, OS governors) run on equal
footing over the same trace.

Built-in registry entries
-------------------------
``agft``            the paper's contextual-bandit tuner (LinUCB + pruning
                    + refinement + Page-Hinkley convergence)
``agft-switchcost`` AGFT with DVFS transitions priced into the reward
                    (switching-aware bandits, arXiv:2410.11855)
``agft-2d``         phase-disaggregated AGFT: learns a ``(f_prefill,
                    f_decode)`` pair over a pruned product action space
                    seeded around the analytic per-phase EDP optima
                    (GreenLLM, arXiv:2508.16449; see
                    ``repro_torch.core.tuner2d`` / ``repro_torch.policies.phased``)
``greenllm-rule``   static per-phase clocks from the same analytic sweep —
                    the rule comparator for the 2-D surface (event-loop
                    mode only; batched mode refuses phased policies)
``static``          one fixed frequency for the whole run (locked clocks)
``oracle``          best *fixed* frequency from an offline EDP sweep
``ondemand``        utilization-threshold rule DVFS (Linux ondemand style)
``slo``             latency-budget AIMD feedback controller
                    (GreenLLM-style); ``mode="ttft"`` budgets first-token
                    latency instead of TPOT
``slo-ttft``        shorthand for ``slo`` in TTFT-budget mode
``observer``        records telemetry windows, never actuates (exact
                    baseline time series for phase benchmarks)
``global``          FLEET scope: one frequency for all nodes, an inner
                    policy (default agft) driven by fleet-aggregated
                    telemetry — attach via ``ServingCluster(...,
                    fleet_policy="global")`` (see ``repro_torch.policies.fleet``)
``hierarchy``       FLEET scope: power-cap coordinator — water-fills a
                    cluster power budget (``power_cap_w``) into per-node
                    frequency bands on FLEET_TICK while node-local
                    policies fine-tune inside them via the optional
                    ``set_band`` hook (see ``repro_torch.policies.hierarchy``)
``hierarchy-uniform``  FLEET scope: the capped single-frequency
                    comparator (``hierarchy`` with ``uniform=True``)
``fleet-meter``     FLEET scope: observe-only carrier of ``power_cap_w``
                    so uncoordinated runs are metered for cap violations
                    under the same event-loop meter as the hierarchy

Registering a new policy
------------------------
Subclass :class:`WindowedPolicy` (or provide any object with
``maybe_act``) and register a factory taking ``(hardware, **kwargs)``::

    from repro_torch.policies import WindowedPolicy, register_policy

    @register_policy("powersave")
    class PowersavePolicy(WindowedPolicy):
        phase_name = "powersave"
        def decide(self, window, engine):
            return self.hw.f_min

    get_policy("powersave")                    # constructs with defaults
    get_policy("powersave", sampling_period_s=0.4)

Classes register directly because they are callable with the factory
signature; plain functions work too (see ``agft.py``). Names are
case-insensitive and must be unique. Per-node heterogeneous mixes are
first-class: ``ServingCluster(..., policies=["agft", "slo", None])``
resolves names through this registry.
"""
from repro_torch.policies.base import (PowerPolicy, TelemetryRecorder,
                                 WindowedPolicy)
from repro_torch.policies.registry import (available_policies, get_policy,
                                     register_policy)
from repro_torch.policies.fixed import (OracleFixedPolicy, StaticPolicy,
                                  snap_to_grid)
from repro_torch.policies.rules import OndemandPolicy, SLOAwareLatencyPolicy
from repro_torch.policies.agft import make_agft, make_agft_switchcost
from repro_torch.policies.phased import GreenLLMRulePolicy, make_agft_2d
from repro_torch.policies.fleet import (FleetPolicy, FleetTelemetryView,
                                  GlobalFrequencyPolicy)
from repro_torch.policies.hierarchy import (BandCoordinator, FleetPowerMeter,
                                      full_busy_power_w, waterfill)

__all__ = ["PowerPolicy", "WindowedPolicy", "TelemetryRecorder",
           "available_policies", "get_policy", "register_policy",
           "StaticPolicy", "OracleFixedPolicy", "OndemandPolicy",
           "SLOAwareLatencyPolicy", "make_agft", "make_agft_switchcost",
           "make_agft_2d", "GreenLLMRulePolicy",
           "snap_to_grid", "FleetPolicy", "FleetTelemetryView",
           "GlobalFrequencyPolicy", "BandCoordinator", "FleetPowerMeter",
           "full_busy_power_w", "waterfill"]
