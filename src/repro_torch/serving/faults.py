"""Seeded fault injection for the discrete-event serving core.

The reproduction historically simulated a perfectly healthy fleet: every
``set_frequency`` landed, every telemetry window was complete, and no
node ever died. Real clusters are dominated by exactly those failures,
and online bandit DVFS is known to be fragile to corrupted feedback
(switching-aware bandits, arXiv:2410.11855) while SLO-aware controllers
must hold their guarantees precisely when capacity drops (GreenLLM,
arXiv:2508.16449). This module injects four fault classes into the
event loop (``repro_torch.serving.driver``) as first-class ``NODE_FAULT`` /
``NODE_RECOVER`` events:

``crash``      node churn: a node goes dark for an MTTR-sampled outage;
               its in-flight and queued requests are evacuated and
               re-routed through the delivery schedule with exponential
               backoff under a bounded retry budget (budget exhausted ->
               the request is dropped and counted)
``dvfs``       flaky actuation: ``set_frequency`` silently sticks (the
               call is lost) or lags (applies after an extra stall) —
               policies must detect the divergence from telemetry and
               re-issue
``thermal``    throttling: the node's frequency envelope is clamped to a
               cap for a sampled window; the clamp composes with fleet-
               coordinator bands (the effective band is the
               intersection) and forces an immediate DVFS transition
               when the running frequency exceeds the cap
``telemetry``  dropouts: a metric scrape fails, blanking the monitor
               window; the *next* successful window spans the gap and is
               flagged stale so policies can refuse to learn from it

Determinism contract: every node draws from its own RNG streams derived
from ``(seed, node_id, fault_class)`` — adding or removing a node never
shifts another node's fault sequence, the same per-entity independence
the :class:`repro_torch.serving.network.NetworkModel` submit-order stream
follows per cluster. A :class:`FaultModel` built from the same spec and
seed replays the identical fault schedule on the identical trace.

Graceful degradation lives with the consumers: ``AGFTTuner`` freezes
bandit updates on faulted/stale windows (no poisoning ``LinUCBBank``
statistics with corrupted rewards) and holds a safe frequency,
``WindowedPolicy`` skips decisions on blanked windows, the
``BandCoordinator`` re-water-fills the power budget over surviving nodes
on the next fleet tick, and the event loop stops delivering to dead
nodes and drains retries on recovery. With no fault model attached
(or the ``none`` preset) every code path is byte-identical to the
healthy simulation — both committed goldens hold.

Spec grammar (``FaultModel.from_spec``)::

    preset                       none | flaky-dvfs | node-churn |
                                 thermal | lossy-telemetry
    clause                       class:key=value[,key=value...]
    spec                         clause[;clause...]   (presets allowed
                                 as clauses; later clauses override)

    crash:mttf=60,mttr=5,retries=4,backoff=0.25
    dvfs:stick=0.35,lag=0.01
    thermal:mtbf=45,duration=8,cap=0.55
    telemetry:drop=0.3
    node-churn;telemetry:drop=0.5      # preset + override combine
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: fault-class indices salting the per-node RNG streams — one stream per
#: (seed, node, class) so classes never perturb each other's sequences
_STREAM_CRASH = 0
_STREAM_THERMAL = 1
_STREAM_DVFS = 2
_STREAM_TELEMETRY = 3

#: action kinds carried by the fault model's internal event heap
ONSET_ACTIONS = ("crash", "thermal-on")
RECOVER_ACTIONS = ("recover", "thermal-off")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Static description of the injected fault mix (times in sim
    seconds; a 0 rate/probability disables that class entirely)."""
    #: mean time to failure for node crashes (exponential); 0 = no churn
    crash_mttf_s: float = 0.0
    #: mean time to repair (exponential)
    crash_mttr_s: float = 5.0
    #: re-route attempts per request before it is dropped (0 = naive
    #: no-retry baseline: a crash loses every evacuated request)
    retry_budget: int = 3
    #: exponential-backoff base: attempt k is delayed ``backoff * 2**k``
    retry_backoff_s: float = 0.25
    #: probability an individual ``set_frequency`` call is silently lost
    dvfs_stick_prob: float = 0.0
    #: extra actuation stall billed to the clock when a flaky transition
    #: does land (the "lags" half of stick-or-lag)
    dvfs_lag_s: float = 0.0
    #: mean time between thermal-throttle onsets; 0 = no throttling
    thermal_mtbf_s: float = 0.0
    #: mean throttle-window duration (exponential)
    thermal_duration_s: float = 10.0
    #: frequency cap while throttled, as a fraction of f_max (clamped to
    #: the hardware envelope)
    thermal_cap_frac: float = 0.6
    #: probability an individual telemetry scrape fails (blank window)
    telemetry_drop_prob: float = 0.0

    @property
    def any_active(self) -> bool:
        return (self.crash_mttf_s > 0.0 or self.dvfs_stick_prob > 0.0
                or self.dvfs_lag_s > 0.0 or self.thermal_mtbf_s > 0.0
                or self.telemetry_drop_prob > 0.0)


#: named fault mixes for the CLI / benchmarks; rates are sized for the
#: benchmark traces (minutes of simulated serving), not datacenter MTTFs
PRESETS: Dict[str, FaultConfig] = {
    "none": FaultConfig(),
    "flaky-dvfs": FaultConfig(dvfs_stick_prob=0.35),
    "node-churn": FaultConfig(crash_mttf_s=60.0, crash_mttr_s=5.0,
                              retry_budget=4, retry_backoff_s=0.25),
    "thermal": FaultConfig(thermal_mtbf_s=45.0, thermal_duration_s=8.0,
                           thermal_cap_frac=0.55),
    "lossy-telemetry": FaultConfig(telemetry_drop_prob=0.3),
}

#: spec-clause field maps: ``class:key=value`` -> FaultConfig field
_CLAUSE_FIELDS: Dict[str, Dict[str, str]] = {
    "crash": {"mttf": "crash_mttf_s", "mttr": "crash_mttr_s",
              "retries": "retry_budget", "backoff": "retry_backoff_s"},
    "dvfs": {"stick": "dvfs_stick_prob", "lag": "dvfs_lag_s"},
    "thermal": {"mtbf": "thermal_mtbf_s", "duration": "thermal_duration_s",
                "cap": "thermal_cap_frac"},
    "telemetry": {"drop": "telemetry_drop_prob"},
}


def parse_fault_spec(spec: str) -> FaultConfig:
    """Parse the spec grammar (module docstring) into a
    :class:`FaultConfig`. Presets may appear as clauses; later clauses
    override earlier fields."""
    fields: Dict[str, object] = {}
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if clause in PRESETS:
            fields.update(dataclasses.asdict(PRESETS[clause]))
            continue
        name, sep, body = clause.partition(":")
        name = name.strip()
        if name not in _CLAUSE_FIELDS:
            raise ValueError(
                f"unknown fault clause {name!r}; presets: "
                f"{', '.join(sorted(PRESETS))}; classes: "
                f"{', '.join(sorted(_CLAUSE_FIELDS))}")
        if not sep:
            raise ValueError(f"fault clause {name!r} needs key=value "
                             f"settings (e.g. {name}:...)")
        fmap = _CLAUSE_FIELDS[name]
        for kv in body.split(","):
            key, sep2, val = kv.partition("=")
            key = key.strip()
            if not sep2 or key not in fmap:
                raise ValueError(
                    f"bad setting {kv!r} in fault clause {name!r}; "
                    f"keys: {', '.join(sorted(fmap))}")
            field = fmap[key]
            fields[field] = (int(val) if field == "retry_budget"
                             else float(val))
    cfg = FaultConfig(**fields)
    if cfg.retry_budget < 0:
        raise ValueError("retry budget must be >= 0")
    if not (0.0 <= cfg.dvfs_stick_prob <= 1.0
            and 0.0 <= cfg.telemetry_drop_prob <= 1.0):
        raise ValueError("fault probabilities must be in [0, 1]")
    return cfg


class NodeFaultState:
    """Per-node fault surface, attached to the engine as
    ``engine.fault_state`` — the feature-detection point for policies
    (``getattr(engine, "fault_state", None)``) and the actuation filter
    for the engine's ``set_frequency``.

    RNG streams are per ``(seed, node_id, class)`` so the node's fault
    sequence is a pure function of its own identity (the determinism
    satellite: membership changes never shift a peer's schedule).
    """

    __slots__ = ("node_id", "config", "down", "thermal_cap_mhz",
                 "last_disruption_t", "bypass", "sticks", "lags",
                 "scrape_drops", "crashes", "thermal_events",
                 "_rng_crash", "_rng_thermal", "_rng_dvfs",
                 "_rng_telemetry")

    def __init__(self, node_id: int, config: FaultConfig, seed: int):
        self.node_id = node_id
        self.config = config
        self.down = False
        self.thermal_cap_mhz: Optional[float] = None
        #: virtual time of the latest disruption touching this node —
        #: policies freeze windows that overlap it
        self.last_disruption_t: float = -np.inf
        #: loop-internal escape hatch: a forced clamp (thermal onset)
        #: must not itself stick
        self.bypass = False
        self.sticks = 0
        self.lags = 0
        self.scrape_drops = 0
        self.crashes = 0
        self.thermal_events = 0
        self._rng_crash = np.random.default_rng(
            (seed, node_id, _STREAM_CRASH))
        self._rng_thermal = np.random.default_rng(
            (seed, node_id, _STREAM_THERMAL))
        self._rng_dvfs = np.random.default_rng(
            (seed, node_id, _STREAM_DVFS))
        self._rng_telemetry = np.random.default_rng(
            (seed, node_id, _STREAM_TELEMETRY))

    # -- schedule sampling (consumed by FaultModel only) ---------------
    def sample_crash_gap(self) -> float:
        return float(self._rng_crash.exponential(self.config.crash_mttf_s))

    def sample_repair(self) -> float:
        return float(self._rng_crash.exponential(
            max(self.config.crash_mttr_s, 1e-6)))

    def sample_thermal_gap(self) -> float:
        return float(self._rng_thermal.exponential(
            self.config.thermal_mtbf_s))

    def sample_thermal_window(self) -> float:
        return float(self._rng_thermal.exponential(
            max(self.config.thermal_duration_s, 1e-6)))

    # -- engine-facing hooks -------------------------------------------
    def note_disruption(self, t: float) -> None:
        if t > self.last_disruption_t:
            self.last_disruption_t = t

    def disrupted_since(self, t: float) -> bool:
        """Did any fault touch this node at or after virtual time ``t``
        (telemetry-window staleness test for policies)?"""
        return self.last_disruption_t >= t

    def filter_set_frequency(self, f: float
                             ) -> Tuple[Optional[float], float]:
        """Actuation filter applied inside ``engine.set_frequency``:
        returns ``(effective_frequency_or_None, extra_stall_s)``. None
        means the call was silently lost (stuck actuator). A thermal
        throttle clamps whatever does land."""
        c = self.config
        extra = 0.0
        if not self.bypass and (c.dvfs_stick_prob > 0.0
                                or c.dvfs_lag_s > 0.0):
            u = float(self._rng_dvfs.random())
            if u < c.dvfs_stick_prob:
                self.sticks += 1
                return None, 0.0
            if c.dvfs_lag_s > 0.0:
                self.lags += 1
                extra = c.dvfs_lag_s
        if self.thermal_cap_mhz is not None:
            f = min(f, self.thermal_cap_mhz)
        return f, extra

    def scrape_dropped(self, now: float) -> bool:
        """One telemetry scrape attempt: True if it failed (blank
        window). Consumes the node's telemetry stream only when dropouts
        are configured, so the healthy path stays stream-silent."""
        c = self.config
        if c.telemetry_drop_prob <= 0.0 or self.down:
            return False
        if float(self._rng_telemetry.random()) < c.telemetry_drop_prob:
            self.scrape_drops += 1
            self.note_disruption(now)
            return True
        return False


@dataclasses.dataclass
class FaultAction:
    """One due fault transition popped by the event loop."""
    t: float
    node: int
    kind: str          # "crash" | "recover" | "thermal-on" | "thermal-off"
    cap_mhz: Optional[float] = None    # thermal-on payload


class FaultModel:
    """Seeded fault-event source for the event loop (router-pattern:
    ``next_time()`` / ``pop_due(t)``), plus the retry/re-route state the
    crash path needs.

    Bind it to a set of nodes once (``bind``); binding attaches a
    :class:`NodeFaultState` to every engine and seeds each node's first
    onset events. The model outlives a single ``EventLoop`` the same way
    the delivery schedule does, so repeated drains keep consuming one
    coherent fault timeline.
    """

    def __init__(self, config: Optional[FaultConfig] = None, *,
                 seed: int = 0, **overrides):
        if config is None:
            config = FaultConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.seed = seed
        self.states: List[NodeFaultState] = []
        self._engines: Optional[List[object]] = None
        self._heap: List[Tuple[float, int, int, FaultAction]] = []
        self._seq = 0
        #: optional richer re-route target picker installed by
        #: ServingCluster: ``route(engines, request, up_mask) -> idx``
        self.route = None
        #: optional NetworkModel pricing re-route deliveries (hops +
        #: router queueing on top of the backoff delay)
        self.network = None
        # aggregate accounting (per-node detail lives on the states)
        self.crashes = 0
        self.recoveries = 0
        self.thermal_events = 0
        self.reroutes = 0
        self.retries = 0
        self.dropped: List[object] = []     # retry-budget-exhausted

    @classmethod
    def from_spec(cls, spec: str, *, seed: int = 0) -> "FaultModel":
        """Build from a preset name or the clause grammar (module
        docstring)."""
        return cls(parse_fault_spec(spec), seed=seed)

    # ------------------------------------------------------------------
    @property
    def active(self) -> bool:
        return self.config.any_active

    @property
    def drops(self) -> int:
        return len(self.dropped)

    def bind(self, engines: Sequence[object]) -> None:
        """Attach per-node fault state and seed first onset events.
        Idempotent for the same engine list (ServingCluster binds at
        construction; a direct EventLoop user may rebind harmlessly)."""
        engines = list(engines)
        if self._engines is not None:
            if [id(e) for e in engines] == [id(e) for e in self._engines]:
                return
            raise ValueError("FaultModel is already bound to a different "
                             "engine set; build one model per cluster")
        self._engines = engines
        c = self.config
        for i, eng in enumerate(engines):
            st = NodeFaultState(i, c, self.seed)
            self.states.append(st)
            eng.fault_state = st
            if c.crash_mttf_s > 0.0:
                self._push(st.sample_crash_gap(), FaultAction(
                    0.0, i, "crash"))
            if c.thermal_mtbf_s > 0.0:
                self._push(st.sample_thermal_gap(), FaultAction(
                    0.0, i, "thermal-on"))

    def _push(self, t: float, action: FaultAction) -> None:
        action.t = t
        heapq.heappush(self._heap, (t, self._seq, action.node, action))
        self._seq += 1

    # -- event-source surface (router pattern) -------------------------
    def next_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def next_is_onset(self) -> bool:
        """Whether the head action starts a fault (NODE_FAULT) rather
        than ends one (NODE_RECOVER) — the loop labels its heap entry
        accordingly."""
        return bool(self._heap) and self._heap[0][3].kind in ONSET_ACTIONS

    def pop_due(self, t: float) -> List[FaultAction]:
        """All fault transitions due at or before ``t``, applying state
        flips and scheduling each consequence (repair after crash, next
        onset after repair) from the node's own streams."""
        out: List[FaultAction] = []
        while self._heap and self._heap[0][0] <= t:
            due, _, _, action = heapq.heappop(self._heap)
            st = self.states[action.node]
            kind = action.kind
            if kind == "crash":
                if st.down:          # already dark (overlap): reschedule
                    continue
                st.down = True
                st.crashes += 1
                self.crashes += 1
                st.note_disruption(due)
                self._push(due + st.sample_repair(),
                           FaultAction(0.0, action.node, "recover"))
            elif kind == "recover":
                st.down = False
                self.recoveries += 1
                st.note_disruption(due)
                self._push(due + st.sample_crash_gap(),
                           FaultAction(0.0, action.node, "crash"))
            elif kind == "thermal-on":
                cap = self._thermal_cap()
                st.thermal_cap_mhz = cap
                st.thermal_events += 1
                self.thermal_events += 1
                st.note_disruption(due)
                action.cap_mhz = cap
                self._push(due + st.sample_thermal_window(),
                           FaultAction(0.0, action.node, "thermal-off"))
            elif kind == "thermal-off":
                st.thermal_cap_mhz = None
                st.note_disruption(due)
                self._push(due + st.sample_thermal_gap(),
                           FaultAction(0.0, action.node, "thermal-on"))
            out.append(action)
        return out

    def _thermal_cap(self) -> float:
        """Thermal frequency cap in MHz (requires a bound engine for the
        hardware envelope)."""
        hw = self._engines[0].hardware
        cap = self.config.thermal_cap_frac * hw.f_max
        return float(min(max(cap, hw.f_min), hw.f_max))

    # -- crash re-route support ----------------------------------------
    def backoff_delay(self, attempt: int) -> float:
        """Exponential backoff for re-route attempt ``attempt`` (0-based)."""
        return self.config.retry_backoff_s * (2.0 ** attempt)

    def pick_node(self, engines: Sequence[object], request) -> int:
        """Re-route target: the installed cluster router over up nodes,
        else the least-loaded up node; falls back to the least-loaded
        node overall when the whole fleet is dark (the retry will bounce
        with backoff until a recovery or the budget runs out)."""
        up = [i for i, st in enumerate(self.states) if not st.down]
        pool = up if up else list(range(len(engines)))
        if self.route is not None and up:
            idx = self.route(engines, request, up)
            if idx in up:
                return idx
        return min(pool, key=lambda i: (
            engines[i].sched.num_running() + engines[i].sched.num_waiting()
            + engines[i].num_pending))

    def counters(self) -> Dict[str, int]:
        """Aggregate fault accounting for summaries/benchmarks."""
        return {
            "crashes": self.crashes,
            "recoveries": self.recoveries,
            "thermal_events": self.thermal_events,
            "reroutes": self.reroutes,
            "retries": self.retries,
            "dropped_retry": self.drops,
            "dvfs_sticks": sum(s.sticks for s in self.states),
            "dvfs_lags": sum(s.lags for s in self.states),
            "telemetry_drops": sum(s.scrape_drops for s in self.states),
        }
