"""Hierarchical power-cap fleet coordination: per-node frequency *bands*.

The two extremes of cluster frequency control already exist in this repo:
fully-local closed loops (the paper's AGFT per node, no coordination) and
the fully-global single-frequency controller (``repro_torch.policies.fleet``).
This module is the hierarchy in between — the same two-level shape
GreenLLM (arXiv:2508.16449) uses for SLO-aware cluster DVFS, applied to
the datacenter power-cap scenario:

* **Fleet level** (:class:`BandCoordinator`, FLEET_TICK cadence): split a
  cluster-wide power budget ``power_cap_w`` into per-node frequency bands
  ``[f_lo, f_hi]`` by load-weighted water-filling over recent per-node
  power draw. The per-node power budget maps to ``f_hi`` through the
  hardware's full-busy power curve (conservative: a node pinned at or
  below ``f_hi`` cannot exceed its budget even fully loaded, so the fleet
  cannot exceed the cap), and ``f_lo = f_hi - band_width`` leaves the
  node room to fine-tune downward.
* **Node level** (every iteration window): the node's own policy — AGFT,
  SLO, ondemand, static — keeps optimizing *inside* its band via the
  optional ``set_band(f_lo, f_hi)`` hook (``repro_torch.policies.base``). AGFT
  masks LinUCB arms outside the band (statistics survive band changes);
  windowed rule policies clamp their decisions.

Band protocol (driver contract, ``repro_torch.serving.driver``)
---------------------------------------------------------
A fleet policy that sets ``coordinates_bands = True`` exposes ``bands``
— a list of per-node ``(f_lo, f_hi)`` tuples (or ``None``) refreshed by
each ``act(engines, now)`` call. After every FLEET_TICK the event loop
propagates each band to the node's policy (``set_band``, when the policy
has the hook) and clamps the engine's *current* frequency into the band;
a band that excludes the running frequency therefore forces an immediate
DVFS transition, billed like any other (``freq_transitions_total``, plus
transition energy/stall when the hardware prices them). The optional
``initial_bands(engines)`` hook lets the coordinator cap the fleet from
t=0, before any telemetry exists.

Any fleet policy may also declare ``power_cap_w``: the event loop then
meters fleet power draw between consecutive FLEET_TICKs and accumulates
``cap_violation_s`` (seconds of tick intervals whose mean draw exceeded
the cap) — :class:`FleetPowerMeter` is the no-actuation carrier of that
attribute for measuring *uncoordinated* baselines under the same meter.

With ``power_cap_w=None`` the coordinator never produces bands, and node
policies with no band set make bit-identical decisions to the
uncoordinated run (``tests/golden_agft_decisions.json`` holds).

Usage::

    ServingCluster(cfg, n_nodes=4, policies=["agft"] * 4,
                   fleet_policy=get_policy("hierarchy", power_cap_w=800.0))
    python -m repro_torch.launch.serve --nodes 4 --fleet-policy hierarchy \
        --power-cap-w 800 --policy agft
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.energy.power_model import HardwareSpec
from repro_torch.policies.registry import register_policy

Band = Tuple[float, float]
HardwareArg = Union[HardwareSpec, Sequence[HardwareSpec]]


def _primary_spec(hardware: HardwareArg) -> HardwareSpec:
    """First spec of a per-node list, or the spec itself — the fleet-policy
    registry convention: ``hardware`` may carry per-node specs for mixed
    fleets, and policies that govern one value per fleet use the first."""
    if isinstance(hardware, HardwareSpec):
        return hardware
    return list(hardware)[0]


def full_busy_power_w(spec: HardwareSpec, f_mhz: float) -> float:
    """Worst-case (fully busy, compute and memory pipelines saturated)
    node power draw at ``f_mhz`` — the same CMOS decomposition the DVFS
    model prices iterations with, at u_busy = u_mem = 1. Monotone in f,
    so budget -> frequency inverts by table lookup."""
    fr = min(max(f_mhz / spec.f_max, 1e-3), 1.0)
    return (spec.p_idle + spec.p_static_active
            + spec.p_dyn_compute * fr ** spec.alpha + spec.p_dyn_memory)


def waterfill(budget: float, weights: Sequence[float],
              demands: Sequence[float]) -> List[float]:
    """Classic water-filling: split ``budget`` proportionally to
    ``weights``, capping each share at ``demands[i]`` and redistributing
    the surplus among the uncapped until the budget (or every demand) is
    exhausted. Returns per-item allocations; sums to
    ``min(budget, sum(demands))`` up to float error."""
    n = len(weights)
    alloc = [0.0] * n
    active = [i for i in range(n) if demands[i] > 0.0]
    budget = max(float(budget), 0.0)
    while active and budget > 1e-9:
        wsum = sum(weights[i] for i in active)
        if wsum > 0.0:
            share = {i: budget * weights[i] / wsum for i in active}
        else:
            share = {i: budget / len(active) for i in active}
        capped = [i for i in active
                  if alloc[i] + share[i] >= demands[i] - 1e-12]
        if not capped:
            for i in active:
                alloc[i] += share[i]
            budget = 0.0
            break
        for i in capped:
            budget -= demands[i] - alloc[i]
            alloc[i] = demands[i]
            active.remove(i)
    # demands PRIORITIZE scarce budget, they don't waste slack: whatever
    # every demand left on the table flows back proportional to weights
    # (harmless over-provisioning — the frequency map saturates at f_max)
    if budget > 1e-9:
        wsum = sum(weights)
        for i in range(n):
            alloc[i] += (budget * weights[i] / wsum if wsum > 0.0
                         else budget / n)
    return alloc


@register_policy("hierarchy")
class BandCoordinator:
    """Fleet-scope power-cap coordinator: budget -> per-node bands.

    On each FLEET_TICK it reads one telemetry snapshot per node and

    1. weighs nodes by instantaneous load (running + waiting requests;
       uniform on the first tick or an idle fleet),
    2. caps each node's *demand* at ``ramp_headroom`` x its recent power
       draw (a quiet node releases budget to hungry peers but can still
       ramp geometrically, one headroom factor per tick), never below the
       physics floor ``full_busy_power_w(f_min)`` nor above
       ``full_busy_power_w(f_max)``,
    3. water-fills the cap over ``(weights, demands)`` on top of a
       ``p_idle`` floor per node (slack the demands leave behind flows
       back, so demand capping only bites when the budget is scarce), and
    4. maps each node budget to ``f_hi`` = the highest grid frequency
       whose full-busy draw fits the budget (conservative: the node
       cannot violate its budget even fully loaded). The cap is a
       one-sided constraint, so ``f_lo`` defaults to ``f_min`` — the node
       policy remains free to clock *down* to its EDP optimum; pass
       ``band_width_mhz`` to floor the band at ``f_hi - band_width``
       (latency protection at the price of energy).

    ``uniform=True`` degenerates to the fair capped *single-frequency*
    comparator: one ``f`` for every node with ``n * full_busy_power_w(f)
    <= power_cap_w`` and zero band width — the thing the hierarchy must
    beat on EDP (``benchmarks/tab_powercap.py``).

    ``power_cap_w=None`` disables actuation entirely (no bands are ever
    produced) so attaching the coordinator is decision-neutral.
    """

    scope = "fleet"
    coordinates_bands = True

    def __init__(self, hardware: HardwareArg,
                 power_cap_w: Optional[float] = None,
                 sampling_period_s: float = 0.8,
                 band_width_mhz: Optional[float] = None,
                 ramp_headroom: float = 2.0,
                 uniform: bool = False):
        # ``hardware`` may be one spec (homogeneous fleet, the historical
        # form) or a per-node spec list for mixed fleets. The primary spec
        # keeps the legacy attributes; per-spec inversion tables are built
        # lazily. ``act``/``initial_bands`` refresh the node->spec mapping
        # from the engines they are handed, so the constructor list is
        # only the pre-telemetry default.
        if isinstance(hardware, HardwareSpec):
            specs = [hardware]
        else:
            specs = list(hardware)
            if not specs:
                raise ValueError("empty per-node hardware list")
        self.hw = specs[0]
        self._node_specs: Optional[List[HardwareSpec]] = (
            specs if any(sp != self.hw for sp in specs) else None)
        self.power_cap_w = power_cap_w
        self.sampling_period_s = sampling_period_s
        self.band_width_mhz = (float(band_width_mhz)
                               if band_width_mhz is not None else None)
        self.ramp_headroom = float(ramp_headroom)
        self.uniform = uniform
        # budget -> frequency inversion table (power is monotone in f)
        self._grid = self.hw.frequencies()
        self._grid_power = np.array([full_busy_power_w(self.hw, f)
                                     for f in self._grid])
        self._p_fmin = float(self._grid_power[0])
        self._p_fmax = float(self._grid_power[-1])
        #: spec -> (grid, grid_power, p_fmin, p_fmax) for non-primary specs
        self._tables: dict = {}
        self.bands: Optional[List[Band]] = None
        self.history: List[dict] = []
        self._prev_energy: Optional[List[float]] = None
        self._prev_t: float = 0.0

    # ------------------------------------------------------------------
    def _table(self, spec: HardwareSpec):
        """Per-spec budget->frequency inversion table (mixed fleets)."""
        if spec == self.hw:
            return self._grid, self._grid_power, self._p_fmin, self._p_fmax
        tab = self._tables.get(spec)
        if tab is None:
            grid = spec.frequencies()
            gp = np.array([full_busy_power_w(spec, f) for f in grid])
            tab = (grid, gp, float(gp[0]), float(gp[-1]))
            self._tables[spec] = tab
        return tab

    def _f_for_budget(self, budget_w: float,
                      spec: Optional[HardwareSpec] = None) -> float:
        """Highest grid frequency whose full-busy draw fits the budget
        (f_min when even the floor doesn't fit — can't clock lower)."""
        if spec is None:
            grid, gp = self._grid, self._grid_power
        else:
            grid, gp, _, _ = self._table(spec)
        i = int(np.searchsorted(gp, budget_w + 1e-9, side="right")) - 1
        return grid[max(i, 0)]

    def _compute_bands(self, weights: List[float],
                       draws: List[Optional[float]],
                       down: Optional[List[bool]] = None,
                       specs: Optional[List[HardwareSpec]] = None
                       ) -> List[Optional[Band]]:
        """``down`` (fault injection, ``repro_torch.serving.faults``) excludes
        dead nodes from the water-fill: their weight, demand, and idle
        floor are zero, so the whole budget re-spreads over survivors
        within this tick, and their band is None (nothing to govern).
        With ``down=None`` (or no node down) the arithmetic is exactly
        the historical healthy-fleet path.

        ``specs`` (or the stored node->spec mapping) switches the mixed-
        fleet path on: per-node idle floors, per-spec demand envelopes,
        and per-spec budget->frequency inversion. A homogeneous fleet
        takes the historical single-table arithmetic unchanged (the
        ``n_up * floor`` budget expression is kept verbatim — summing n
        identical floors would round differently)."""
        n = len(weights)
        cap = float(self.power_cap_w)
        if down is not None and not any(down):
            down = None
        specs = specs if specs is not None else self._node_specs
        hetero = (specs is not None
                  and any(sp != self.hw for sp in specs))
        if self.uniform:
            n_up = n if down is None else n - sum(down)
            if hetero:
                # fair capped comparator on a mixed fleet: the same
                # per-node power budget, inverted through each node's own
                # full-busy curve
                fs = [self._f_for_budget(cap / max(n_up, 1), sp)
                      for sp in specs]
                if down is None:
                    return [(f, f) for f in fs]
                return [None if d else (f, f)
                        for f, d in zip(fs, down)]
            f = self._f_for_budget(cap / max(n_up, 1))
            if down is None:
                return [(f, f)] * n
            return [None if d else (f, f) for d in down]
        n_up = n if down is None else n - sum(down)
        if hetero:
            floors = []
            for i in range(n):
                if down is not None and down[i]:
                    floors.append(0.0)
                else:
                    floors.append(min(specs[i].p_idle,
                                      cap / max(n_up, 1)))
        else:
            floor = min(self.hw.p_idle, cap / max(n_up, 1))
            floors = None
        demands = []
        for i, d in enumerate(draws):
            if down is not None and down[i]:
                demands.append(0.0)
                continue
            if hetero:
                _, _, p_fmin_i, p_fmax_i = self._table(specs[i])
                floor_i = floors[i]
            else:
                p_fmin_i, p_fmax_i, floor_i = \
                    self._p_fmin, self._p_fmax, floor
            demand = p_fmax_i
            if d is not None:
                demand = min(demand,
                             max(d * self.ramp_headroom, p_fmin_i))
            demands.append(max(demand - floor_i, 0.0))
        if down is not None:
            weights = [0.0 if dn else w for w, dn in zip(weights, down)]
            if all(w <= 0 for w in weights):
                weights = [0.0 if dn else 1.0 for dn in down]
        elif all(w <= 0 for w in weights):
            weights = [1.0] * n
        budget = (cap - sum(floors) if hetero
                  else cap - n_up * floor)
        extra = waterfill(budget, weights, demands)
        bands: List[Optional[Band]] = []
        for i, a in enumerate(extra):
            if down is not None and down[i]:
                bands.append(None)
                continue
            if hetero:
                sp_i = specs[i]
                hi = self._f_for_budget(floors[i] + a, sp_i)
            else:
                sp_i = self.hw
                hi = self._f_for_budget(floor + a)
            lo = (sp_i.f_min if self.band_width_mhz is None
                  else max(sp_i.f_min, hi - self.band_width_mhz))
            bands.append((lo, hi))
        return bands

    # ------------------------------------------------------------------
    def _engine_specs(self, engines) -> Optional[List[HardwareSpec]]:
        """Refresh the node->spec mapping from live engines (authoritative
        over the constructor default — per-node placement is the loop's)."""
        specs = [getattr(e, "hardware", self.hw) for e in engines]
        self._node_specs = (specs if any(sp != self.hw for sp in specs)
                            else None)
        return self._node_specs

    def initial_bands(self, engines) -> Optional[List[Band]]:
        """Telemetry-free bands for t=0 (uniform weights, unconstrained
        demands) so the fleet is capped from the first event, not from
        the first tick."""
        if self.power_cap_w is None or not len(engines):
            return None
        n = len(engines)
        return self._compute_bands([1.0] * n, [None] * n,
                                   specs=self._engine_specs(engines))

    def act(self, engines, now: float) -> Optional[float]:
        """FLEET_TICK: refresh ``self.bands`` (the event loop propagates
        them to node policies and engines). Returns None — the
        coordinator never sets a single fleet frequency itself."""
        snaps = [e.metrics.snapshot() for e in engines]
        energy = [s["vllm:energy_joules_total"] for s in snaps]
        if self.power_cap_w is None:
            return None
        n = len(engines)
        draws: List[Optional[float]] = [None] * n
        if self._prev_energy is not None \
                and len(self._prev_energy) == n and now > self._prev_t:
            dt = now - self._prev_t
            draws = [(e1 - e0) / dt
                     for e0, e1 in zip(self._prev_energy, energy)]
        weights = [float(s["vllm:num_requests_running"]
                         + s["vllm:num_requests_waiting"]) for s in snaps]
        self._prev_energy, self._prev_t = energy, now
        # fault injection: dead nodes leave the water-fill — the power
        # budget re-spreads over survivors within this tick (their draw
        # history is also voided so recovery doesn't ramp off stale watts)
        down = [getattr(e, "fault_state", None) is not None
                and e.fault_state.down for e in engines]
        if any(down):
            draws = [None if dn else d for d, dn in zip(draws, down)]
        self.bands = self._compute_bands(
            weights, draws, down=down,
            specs=self._engine_specs(engines))
        self.history.append({
            "t": now,
            "bands": list(self.bands),
            "weights": weights,
            "node_power_w": draws,
            "fleet_power_w": (sum(d for d in draws if d is not None)
                              if any(d is not None for d in draws)
                              else None),
        })
        return None

    def maybe_act(self, engine) -> Optional[float]:
        raise TypeError(
            "BandCoordinator is fleet-scope: attach it with "
            "ServingCluster(..., fleet_policy=...), not as a per-node "
            "policy")


@register_policy("hierarchy-uniform")
def make_uniform_coordinator(hardware: HardwareArg,
                             **kwargs) -> BandCoordinator:
    """The capped single-frequency comparator: ``get_policy(
    "hierarchy-uniform", power_cap_w=...)`` == ``get_policy("hierarchy",
    uniform=True, ...)`` — one fleet-wide frequency meeting the cap, no
    per-node bands, no room for node-local fine-tuning."""
    if kwargs.pop("uniform", True) is not True:
        raise ValueError("hierarchy-uniform is fixed to uniform=True")
    return BandCoordinator(hardware, uniform=True, **kwargs)


make_uniform_coordinator.scope = "fleet"


@register_policy("fleet-meter")
class FleetPowerMeter:
    """Observe-only fleet policy: carries ``power_cap_w`` so the event
    loop meters fleet draw and cap-violation seconds on FLEET_TICKs, but
    never actuates — attach it to *uncoordinated* runs (per-node AGFT, no
    coordinator) to measure what they do to a power budget under exactly
    the same meter as the hierarchy (``benchmarks/tab_powercap.py``)."""

    scope = "fleet"
    coordinates_bands = False
    #: never actuates — per-node policies stay in charge of their engines
    observe_only = True

    def __init__(self, hardware: HardwareArg,
                 power_cap_w: Optional[float] = None,
                 sampling_period_s: float = 0.8):
        self.hw = _primary_spec(hardware)
        self.power_cap_w = power_cap_w
        self.sampling_period_s = sampling_period_s

    def act(self, engines, now: float) -> Optional[float]:
        return None

    def maybe_act(self, engine) -> Optional[float]:
        raise TypeError(
            "FleetPowerMeter is fleet-scope: attach it with "
            "ServingCluster(..., fleet_policy=...), not as a per-node "
            "policy")
