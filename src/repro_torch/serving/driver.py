"""The discrete-event serving core: one event loop for every serving shape.

``InferenceEngine.run_until/drain`` and ``ServingCluster.drain`` used to
carry three copies of the same "step, then let the frequency authority
act" loop, later unified into a heap of engine *clocks*. This module grows
that into a proper discrete-event simulation: the heap holds typed, timed
events —

``ARRIVAL``          an idle engine's next request lands; the engine
                     idle-advances (billing idle energy) and iterates
``ITERATION``        an engine with schedulable work runs one
                     continuous-batching iteration, then its per-node
                     policy gets the iteration-complete callback
``FLEET_TICK``       a fleet-scope policy (:class:`repro_torch.policies.fleet.
                     FleetPolicy`) samples aggregated telemetry on its own
                     cadence
``ROUTE``            the router's dispatch pipe (:class:`repro_torch.serving.
                     network.DeliverySchedule`) delivers priced requests
                     to their engines: an arrival is *rescheduled* from
                     its submit-time placement to its network delivery
                     time. A delivery that lands earlier than a node's
                     outstanding event supersedes it (per-node event
                     versioning), and a drained node is revived — the
                     router is a first-class event source, not a
                     pre-drain bulk load
``POLICY_TICK``      per-node policy decision on a wall-clock cadence
                     (``policy_tick_mode="tick"``): telemetry windows are
                     cut at the tick's virtual time, decoupling decision
                     boundaries from iteration boundaries. The default
                     mode (``"iteration"``) keeps the historical
                     behavior — policies gate on the engine clock at
                     iteration boundaries — which stays bit-identical to
                     the pre-event-loop driver (the committed golden
                     trajectory); pure-tick trajectories are pinned by
                     their own golden (``tests/golden_agft_decisions_
                     tick.json``)
``NODE_FAULT`` /     a bound :class:`repro_torch.serving.faults.FaultModel`'s
``NODE_RECOVER``     next transition fires: node crashes (in-flight and
                     queued work evacuated and re-routed with exponential
                     backoff under a bounded retry budget), recoveries
                     (the node rejoins the loop, clock advanced without
                     billing the outage), and thermal throttle flips
                     (the running frequency is force-clamped under the
                     cap and the governing band becomes the intersection
                     of the coordinator band with the thermal envelope).
                     With no fault model — or an all-zero config — none
                     of these paths execute and the loop is byte-
                     identical to the healthy simulation

Hierarchical power capping rides on FLEET_TICK (``repro_torch.policies.
hierarchy``): when the fleet policy declares ``coordinates_bands``, the
loop propagates its per-node ``bands`` after every tick — calling each
node policy's optional ``set_band(f_lo, f_hi)`` hook and clamping the
engine's current frequency into the band, so a band that excludes the
running frequency forces an immediate DVFS transition, billed like any
other. When the fleet policy declares ``power_cap_w``, the loop also
meters fleet draw between consecutive ticks into ``cap_violation_s`` /
``metered_s`` / ``peak_fleet_power_w`` (budget accounting surfaced by
``ServingCluster.summary``).

Each node event is keyed by the engine's ``next_event_time()`` — the next
instant it actually does anything — so idle nodes cost nothing until their
next arrival, and the loop's virtual ``now`` (min over scheduled events)
is a coherent global timeline for fleet controllers and the router. At
equal times, ROUTE events outrank node events (a delivery due at *t* is
visible to an iteration at *t*, exactly as an already-placed arrival
would be); everything else stays FIFO. Nodes are independent simulations,
so per-node trajectories are identical to the old laggard-clock loop;
only the interleaving (and hence where fleet ticks can see the fleet)
changes. O(log n) per event; heterogeneous per-node policies, a
cluster-global controller, and a delayed routing path are all free.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.request import RequestState

#: FLEET_TICK cadence (sim-seconds) when the fleet policy doesn't declare
#: ``sampling_period_s`` — matches the paper's sub-second telemetry window.
DEFAULT_FLEET_TICK_PERIOD_S = 0.8

#: POLICY_TICK cadence when a node policy declares no sampling period of
#: its own (same sub-second window as the fleet default).
DEFAULT_POLICY_TICK_PERIOD_S = 0.8

#: valid ``policy_tick_mode`` values: ``"iteration"`` invokes node
#: policies after every engine step (monitors gate on the engine clock —
#: the golden-pinned historical behavior); ``"tick"`` schedules per-node
#: POLICY_TICK events on the policy's sampling period instead.
POLICY_TICK_MODES = ("iteration", "tick")


class EventKind(enum.IntEnum):
    """What a scheduled event will do when it fires."""
    ARRIVAL = 0        # idle engine: next request lands, then it iterates
    ITERATION = 1      # engine with schedulable work runs one iteration
    FLEET_TICK = 2     # fleet-scope policy samples aggregated telemetry
    ROUTE = 3          # router delivers in-flight requests to engines
    POLICY_TICK = 4    # node policy decides on a wall-clock cadence
    NODE_FAULT = 5     # fault model: crash / thermal-throttle onset
    NODE_RECOVER = 6   # fault model: repair / throttle release


@dataclasses.dataclass
class EngineNode:
    """An engine paired with the power policy that governs it (or None)."""
    engine: object                      # InferenceEngine
    policy: Optional[object] = None     # PowerPolicy (node scope)


def _policy_period(policy) -> float:
    """A node policy's decision cadence: its monitor's sampling period
    (WindowedPolicy, AGFTTuner), a bare ``sampling_period_s`` attribute,
    or the sub-second default."""
    monitor = getattr(policy, "monitor", None)
    period = getattr(monitor, "sampling_period_s", None)
    if period is None:
        period = getattr(policy, "sampling_period_s", None)
    return float(period) if period else DEFAULT_POLICY_TICK_PERIOD_S


class EventLoop:
    """Event-scheduled driver over a set of :class:`EngineNode`.

    At most one node event is outstanding per live node; firing it
    advances the engine one step (``engine.step()`` — idle-advance and/or
    iteration), invokes the node's policy (iteration mode), and
    reschedules at the engine's next event time. ``fleet_policy``
    (optional) receives ``act(engines, now)`` ticks every
    ``fleet_policy.sampling_period_s`` sim-seconds while any node is live
    or deliveries are in flight. ``router`` (optional, a
    :class:`repro_torch.serving.network.DeliverySchedule`) feeds ROUTE events:
    deliveries land in engine arrival heaps at their priced network
    delivery times, superseding stale node events and reviving drained
    nodes. ``policy_tick_mode="tick"`` moves node-policy decisions onto
    per-node POLICY_TICK events (windows cut at tick time). A node leaves
    the loop when it drains or its clock reaches ``t_end``; ``run``
    returns the number of engine steps executed.
    """

    def __init__(self, nodes: Sequence[EngineNode], *,
                 fleet_policy: Optional[object] = None,
                 t_end: Optional[float] = None,
                 max_iters: int = 10_000_000,
                 router: Optional[object] = None,
                 policy_tick_mode: str = "iteration",
                 fault_model: Optional[object] = None):
        if policy_tick_mode not in POLICY_TICK_MODES:
            raise ValueError(
                f"policy_tick_mode must be one of {POLICY_TICK_MODES}, "
                f"got {policy_tick_mode!r}")
        self.nodes = list(nodes)
        self.fleet_policy = fleet_policy
        self.router = router
        self.policy_tick_mode = policy_tick_mode
        # resolved once; the loop never re-reads the policy attribute
        self._fleet_period = getattr(fleet_policy, "sampling_period_s",
                                     DEFAULT_FLEET_TICK_PERIOD_S)
        self.t_end = t_end
        self.max_iters = max_iters
        self.now = 0.0                       # virtual time, never decreases
        self.steps = 0
        self.counts: Dict[EventKind, int] = {k: 0 for k in EventKind}
        # power-budget accounting (active when the fleet policy declares a
        # cap; see repro_torch.policies.hierarchy)
        self._power_cap = getattr(fleet_policy, "power_cap_w", None)
        self.cap_violation_s = 0.0
        self.metered_s = 0.0
        self.metered_energy_j = 0.0
        self.peak_fleet_power_w = 0.0
        self._seq = itertools.count()        # FIFO tie-break at equal times
        self._heap: List[tuple] = []
        # per-node scheduling state: time of the outstanding event (None
        # when the node holds no event) and its version — a delivery that
        # reschedules a node bumps the version, orphaning the heap entry
        self._sched_t: List[Optional[float]] = [None] * len(self.nodes)
        self._ver: List[int] = [0] * len(self.nodes)
        self._live = 0
        for i in range(len(self.nodes)):
            if self._schedule_node(i):
                self._live += 1
        # fault injection (repro_torch.serving.faults): an ACTIVE model turns
        # the loop into a NODE_FAULT/NODE_RECOVER consumer; an absent or
        # all-zero model leaves every healthy path byte-identical
        self.faults = None
        #: the coordinator's last per-node bands, remembered so a thermal
        #: release can restore them after the throttle intersection
        self._coord_band: List[Optional[Tuple[float, float]]] = \
            [None] * len(self.nodes)
        #: observation hook called once per popped event, BEFORE it is
        #: applied (i.e. after the previous event fully settled):
        #: ``on_event(loop, kind, t)`` — the conservation property test
        #: audits request accounting at every step through it
        self.on_event = None
        self._route_t: Optional[float] = None    # earliest armed ROUTE
        self._route_ver = 0     # orphans superseded ROUTE events (faults)
        if fault_model is not None and fault_model.active:
            fault_model.bind(self.engines)
            self.faults = fault_model
            if self.router is None:
                # crash evacuation re-routes through a delivery schedule
                # even when no network model is configured
                from repro_torch.serving.network import DeliverySchedule
                self.router = DeliverySchedule()
            self._arm_fault_event()
        if self.router is not None:
            nxt = self.router.next_time()
            if nxt is not None and (t_end is None or nxt < t_end):
                self._push(nxt, EventKind.ROUTE, -1)
                self._route_t = nxt
        self._meter_t = 0.0
        self._meter_e = 0.0
        if fleet_policy is not None and self._heap:
            start = min(t for t, *_ in self._heap)
            self._meter_t = start
            self._meter_e = self._fleet_energy_j()
            # a band coordinator can cap the fleet from t=0, before any
            # telemetry exists — ask it for initial bands
            init = getattr(fleet_policy, "initial_bands", None)
            if init is not None:
                self._propagate_bands(init(self.engines))
            self._push(start + self._fleet_period, EventKind.FLEET_TICK, -1)
        self._tick_period: List[float] = [0.0] * len(self.nodes)
        # whether a POLICY_TICK is outstanding for the node — a ROUTE
        # revival restarts a dead train, so tick liveness never depends
        # on the caller maintaining ``engine.inflight`` (ServingCluster
        # does; direct EventLoop/drive users need not)
        self._tick_alive: List[bool] = [False] * len(self.nodes)
        if policy_tick_mode == "tick" and self._heap:
            # a node's tick train anchors where the node first gets work:
            # its scheduled event, or — when requests are still in the
            # network — its earliest delivery (identical instants on the
            # zero-delay path, so routed and direct tick trajectories
            # coincide)
            deliveries = (router.first_time_per_node()
                          if router is not None else {})
            for i, node in enumerate(self.nodes):
                if node.policy is None:
                    continue
                self._tick_period[i] = _policy_period(node.policy)
                t0 = self._sched_t[i]
                if t0 is None:
                    t0 = deliveries.get(i)
                if t0 is None:
                    continue        # node never receives work: no ticks
                if t_end is None or t0 < t_end:
                    self._push(t0, EventKind.POLICY_TICK, i)
                    self._tick_alive[i] = True

    # ------------------------------------------------------------------
    @property
    def engines(self) -> List[object]:
        return [n.engine for n in self.nodes]

    def _push(self, t: float, kind: EventKind, node: int) -> None:
        # Same-time ordering: ROUTE outranks node events (a delivery due
        # at t must be visible to an iteration at t, exactly as an
        # already-placed arrival would be) and POLICY_TICK yields to them
        # (a tick coinciding with a node's event observes the engine
        # after it fired, whichever path seeded the event) — so routed
        # and direct configurations order identically at shared instants.
        # Everything else stays FIFO. Node events carry their node's
        # version so a reschedule can orphan them in place.
        if (kind is EventKind.ROUTE or kind is EventKind.NODE_FAULT
                or kind is EventKind.NODE_RECOVER):
            prio = 0
        elif kind is EventKind.POLICY_TICK:
            prio = 2
        else:
            prio = 1
        if node >= 0:
            ver = self._ver[node]
        elif kind is EventKind.ROUTE:
            ver = self._route_ver
        else:
            ver = 0
        heapq.heappush(self._heap,
                       (t, prio, next(self._seq), kind, node, ver))

    def _schedule_node(self, i: int) -> bool:
        """Schedule node ``i``'s next event; False if it has drained."""
        eng = self.nodes[i].engine
        t = eng.next_event_time()
        if t is None:
            self._sched_t[i] = None
            return False
        kind = (EventKind.ITERATION if eng.sched.has_work
                else EventKind.ARRIVAL)
        self._sched_t[i] = t
        self._push(t, kind, i)
        return True

    def _router_pending(self) -> bool:
        return self.router is not None and self.router.next_time() is not None

    # -- hierarchical power capping (repro_torch.policies.hierarchy) ---------
    def _propagate_bands(self, bands) -> None:
        """Deliver per-node frequency bands: hand each band to the node
        policy's optional ``set_band`` hook and clamp the engine's current
        frequency into it — a band excluding the running frequency forces
        a move, billed as a DVFS transition like any other."""
        if not bands:
            return
        faults = self.faults
        for i, (node, band) in enumerate(zip(self.nodes, bands)):
            if band is None:
                continue
            lo, hi = band
            if lo > hi:
                lo, hi = hi, lo
            if faults is not None:
                # remember the coordinator's band and govern by its
                # intersection with any live thermal envelope
                self._coord_band[i] = (lo, hi)
                cap = faults.states[i].thermal_cap_mhz
                if cap is not None:
                    hi = min(hi, cap)
                    lo = min(lo, hi)
            set_band = getattr(node.policy, "set_band", None)
            if set_band is not None:
                set_band(lo, hi)
            eng = node.engine
            f = min(max(eng.frequency, lo), hi)
            if f != eng.frequency:
                eng.set_frequency(f)

    def _fleet_energy_j(self) -> float:
        return sum(n.engine.metrics.c.energy_joules_total
                   for n in self.nodes)

    def _meter_power(self, t: float) -> None:
        """Budget accounting between consecutive FLEET_TICKs: mean fleet
        draw over the interval, peak tracking, and seconds spent above
        the declared cap."""
        if self._power_cap is None:
            return
        e = self._fleet_energy_j()
        if t > self._meter_t:
            dt = t - self._meter_t
            de = e - self._meter_e
            p = de / dt
            self.metered_s += dt
            self.metered_energy_j += de
            if p > self.peak_fleet_power_w:
                self.peak_fleet_power_w = p
            if p > self._power_cap:
                self.cap_violation_s += dt
        self._meter_t, self._meter_e = t, e

    @property
    def mean_fleet_power_w(self) -> float:
        return (self.metered_energy_j / self.metered_s
                if self.metered_s > 0 else 0.0)

    # -- event handlers ------------------------------------------------
    def _fire_route(self, t: float) -> None:
        """Deliver every request due at ``t`` to its engine's arrival
        heap, then repair node scheduling: a delivery earlier than a
        node's outstanding event supersedes it (version bump); a drained
        node comes back to life."""
        t_end = self.t_end
        faults = self.faults
        touched = {}
        for idx, req in self.router.pop_due(t):
            if faults is not None and faults.states[idx].down:
                # the target died while this request was in flight:
                # bounce it back through the retry path instead of
                # delivering into the void
                eng = self.nodes[idx].engine
                if eng.inflight > 0:
                    eng.inflight -= 1
                self._reroute(req, t)
                continue
            self.nodes[idx].engine.deliver(req, t)
            touched[idx] = True
        self.counts[EventKind.ROUTE] += 1
        for idx in touched:
            eng = self.nodes[idx].engine
            if t_end is not None and eng.clock >= t_end:
                continue                     # past the horizon: stays down
            nt = eng.next_event_time()
            if nt is None:
                continue
            if self._sched_t[idx] is None:
                if self._schedule_node(idx):
                    self._live += 1          # revival
            elif nt < self._sched_t[idx]:
                self._ver[idx] += 1          # orphan the stale event
                self._schedule_node(idx)
            if (self.policy_tick_mode == "tick"
                    and not self._tick_alive[idx]
                    and self.nodes[idx].policy is not None
                    and (t_end is None or t < t_end)):
                # the node's tick train died while it was drained —
                # re-anchor it at the delivery that brought it back
                self._push(t, EventKind.POLICY_TICK, idx)
                self._tick_alive[idx] = True
        nxt = self.router.next_time()
        if nxt is not None and (t_end is None or nxt < t_end):
            self._push(nxt, EventKind.ROUTE, -1)
            self._route_t = nxt
        else:
            self._route_t = None

    def _fire_policy_tick(self, t: float, i: int) -> None:
        """One wall-clock policy decision for node ``i``: the policy's
        telemetry window is cut at the tick's virtual time ``t`` (not at
        an iteration boundary). The tick train dies only when the node is
        fully drained — idle gaps between arrivals still tick (a real
        poller doesn't stop polling an idle server)."""
        node = self.nodes[i]
        eng = node.engine
        fs = getattr(eng, "fault_state", None)
        if fs is not None and fs.down:
            self._tick_alive[i] = False      # dark: recovery restarts it
            return
        if (self._sched_t[i] is None and not eng.has_work
                and getattr(eng, "inflight", 0) == 0):
            self._tick_alive[i] = False      # drained: a ROUTE revives it
            return
        self.counts[EventKind.POLICY_TICK] += 1
        tick = getattr(node.policy, "tick", None)
        if tick is not None:
            tick(eng, t)
        else:                                # duck-typed minimal policies
            node.policy.maybe_act(eng)
        nxt = t + self._tick_period[i]
        if self.t_end is None or nxt < self.t_end:
            self._push(nxt, EventKind.POLICY_TICK, i)
        else:
            self._tick_alive[i] = False

    # -- fault injection (repro_torch.serving.faults) ------------------------
    def _work_remains(self) -> bool:
        """Does the loop still owe anyone service? Under faults, a fully
        dark fleet holding unserved requests must keep its fault (and
        fleet) event trains alive until a recovery drains them; healthy
        loops keep the historical live-nodes-or-in-flight test."""
        if self._live > 0 or self._router_pending():
            return True
        if self.faults is not None:
            return any(n.engine.has_work for n in self.nodes)
        return False

    def _arm_fault_event(self) -> None:
        """Arm the loop's single outstanding fault event at the model's
        next transition (constructor seed and post-fire re-arm)."""
        fm = self.faults
        nxt = fm.next_time()
        if nxt is None or (self.t_end is not None and nxt >= self.t_end):
            return
        kind = (EventKind.NODE_FAULT if fm.next_is_onset()
                else EventKind.NODE_RECOVER)
        self._push(nxt, kind, -1)

    def _fire_faults(self, t: float, kind: EventKind) -> None:
        """Apply every fault transition due at ``t`` and re-arm the
        train while anything is left to serve."""
        for action in self.faults.pop_due(t):
            if action.kind == "crash":
                self._crash_node(action.node, t)
            elif action.kind == "recover":
                self._recover_node(action.node, t)
            elif action.kind == "thermal-on":
                self._thermal_flip(action.node, action.cap_mhz)
            else:                              # thermal-off
                self._thermal_flip(action.node, None)
        self.counts[kind] += 1
        if self._work_remains():
            self._arm_fault_event()

    def _arm_route(self, t: float) -> None:
        """Ensure a ROUTE event is armed no later than ``t``: re-routes
        can land ahead of the router's armed event — or revive a train
        that ended. At most one ROUTE event stays live (versioning)."""
        if self.t_end is not None and t >= self.t_end:
            return
        if self._route_t is not None and self._route_t <= t:
            return
        if self._route_t is not None:
            self._route_ver += 1          # orphan the later-armed event
        self._push(t, EventKind.ROUTE, -1)
        self._route_t = t

    def _crash_node(self, i: int, t: float) -> None:
        """Node ``i`` goes dark at ``t``: orphan its outstanding event,
        evacuate its running batch (KV state lost, recompute-style), its
        queue, its already-arrived undelivered heap entries, and its
        in-flight deliveries, re-routing every evacuee through the retry
        path. Arrivals the node owns that haven't happened yet stay
        owned — they re-enter service after recovery."""
        eng = self.nodes[i].engine
        if self._sched_t[i] is not None:
            self._ver[i] += 1                  # orphan the heap entry
            self._sched_t[i] = None
            self._live -= 1
        sched = eng.sched
        evac: List[object] = []
        for req in list(sched.running.values()):
            del sched.running[req.request_id]
            sched.kv.free(req, preempted=True)
            req.state = RequestState.WAITING
            req.prefilled = 0
            req.generated = 0
            req.cached_tokens = 0
            evac.append(req)
        while sched.waiting:
            evac.append(sched.waiting.popleft())
        while eng._pending and eng._pending[0][0] <= t:
            evac.append(heapq.heappop(eng._pending)[2])
        for _, req in self.router.extract_node(i):
            if eng.inflight > 0:
                eng.inflight -= 1
            evac.append(req)
        for req in evac:
            self._reroute(req, t)

    def _reroute(self, req, t: float) -> None:
        """Retry path for an evacuated/bounced request: re-deliver to a
        surviving node after exponential backoff (priced through the
        network model when one exists), or drop it once the retry budget
        is spent."""
        fm = self.faults
        if req.retries >= fm.config.retry_budget:
            req.state = RequestState.DROPPED
            fm.dropped.append(req)
            return
        attempt = req.retries
        req.retries += 1
        fm.retries += 1
        base = t + fm.backoff_delay(attempt)
        deliver = (fm.network.delivery_time(base)
                   if fm.network is not None else base)
        j = fm.pick_node(self.engines, req)
        self.nodes[j].engine.inflight += 1
        fm.reroutes += 1
        req.delivery_time = deliver
        self.router.push(deliver, j, req)
        self._arm_route(deliver)

    def _recover_node(self, i: int, t: float) -> None:
        """Node ``i`` comes back at ``t``: its clock jumps over the
        outage WITHOUT billing idle energy (the node was dark, not
        idling), it rejoins the event heap, and a dead POLICY_TICK train
        restarts."""
        node = self.nodes[i]
        eng = node.engine
        if t > eng.clock:
            eng.clock = t
        if self._sched_t[i] is None and (self.t_end is None
                                         or eng.clock < self.t_end):
            if self._schedule_node(i):
                self._live += 1
        if (self.policy_tick_mode == "tick" and not self._tick_alive[i]
                and node.policy is not None
                and (self.t_end is None or t < self.t_end)):
            self._push(t, EventKind.POLICY_TICK, i)
            self._tick_alive[i] = True

    def _thermal_flip(self, i: int, cap: Optional[float]) -> None:
        """Apply a thermal-throttle flip to node ``i`` (the model already
        flipped its state): onset force-clamps the running frequency
        under the cap — a DVFS transition billed like any other, exempt
        from stick/lag (hardware throttling bypasses the flaky driver
        interface) — and the governing band becomes coordinator band ∩
        thermal envelope; release restores the coordinator's band."""
        node = self.nodes[i]
        eng = node.engine
        if cap is not None and eng.frequency > cap:
            fs = self.faults.states[i]
            fs.bypass = True
            try:
                eng.set_frequency(cap)
            finally:
                fs.bypass = False
        set_band = getattr(node.policy, "set_band", None)
        if set_band is None:
            return
        hw = eng.hardware
        base = self._coord_band[i]
        if base is None:
            base = (hw.f_min, hw.f_max)
        if cap is None:
            set_band(*base)
        else:
            hi = min(base[1], cap)
            set_band(min(base[0], hi), hi)

    # ------------------------------------------------------------------
    def _run_single(self) -> int:
        """Single node, no fleet policy, no router, iteration-gated — the
        overwhelmingly common shape (every benchmark cell): exactly one
        event is ever outstanding, so the loop re-derives it inline
        instead of round-tripping the heap. Trajectories, step counts,
        ``now`` and event counts are identical to the general loop."""
        node = self.nodes[0]
        eng = node.engine
        policy = node.policy
        sched = eng.sched
        t_end = self.t_end
        counts = self.counts
        self._heap.clear()               # constructor's seed event, inlined
        while self.steps < self.max_iters:
            if sched.waiting or sched.running:
                kind = EventKind.ITERATION
                t = eng.clock
            elif eng._pending:
                kind = EventKind.ARRIVAL
                t = eng._pending[0][0]
            else:
                break                    # drained
            if t > self.now:
                self.now = t
            if t_end is not None and eng.clock >= t_end:
                break
            eng.step()
            if policy is not None:
                policy.maybe_act(eng)
            self.steps += 1
            counts[kind] += 1
        return self.steps

    def run(self) -> int:
        if (len(self.nodes) == 1 and self.fleet_policy is None
                and self.router is None and self.faults is None
                and self.policy_tick_mode == "iteration"):
            return self._run_single()
        t_end = self.t_end
        iteration_gated = self.policy_tick_mode == "iteration"
        while self._heap and self.steps < self.max_iters:
            t, _, _, kind, i, ver = heapq.heappop(self._heap)
            if self.on_event is not None:
                self.on_event(self, kind, t)
            if t > self.now:
                self.now = t

            if kind is EventKind.FLEET_TICK:
                if not self._work_remains():
                    continue                   # fleet dies with nodes
                self.fleet_policy.act(self.engines, t)
                self._propagate_bands(getattr(self.fleet_policy, "bands",
                                              None))
                self._meter_power(t)
                self.counts[kind] += 1
                nxt = t + self._fleet_period
                if t_end is None or nxt < t_end:
                    self._push(nxt, EventKind.FLEET_TICK, -1)
                continue

            if (kind is EventKind.NODE_FAULT
                    or kind is EventKind.NODE_RECOVER):
                self._fire_faults(t, kind)
                continue

            if kind is EventKind.ROUTE:
                if ver == self._route_ver:
                    self._fire_route(t)
                continue

            if kind is EventKind.POLICY_TICK:
                self._fire_policy_tick(t, i)
                continue

            if ver != self._ver[i]:
                continue                       # superseded by a delivery
            self._sched_t[i] = None
            node = self.nodes[i]
            eng = node.engine
            if not eng.has_work or (t_end is not None
                                    and eng.clock >= t_end):
                self._live -= 1
                continue
            eng.step()
            if iteration_gated and node.policy is not None:
                node.policy.maybe_act(eng)
            self.steps += 1
            self.counts[kind] += 1
            if not self._schedule_node(i):
                self._live -= 1
        if self.fleet_policy is not None:
            # final flush: the drain tail past the last FLEET_TICK must be
            # metered too, or cap violations there would go uncounted
            self._meter_power(max([self.now]
                                  + [n.engine.clock for n in self.nodes]))
        return self.steps


def drive(nodes: Sequence[EngineNode], *, t_end: Optional[float] = None,
          max_iters: int = 10_000_000,
          fleet_policy: Optional[object] = None,
          router: Optional[object] = None,
          policy_tick_mode: str = "iteration",
          fault_model: Optional[object] = None) -> int:
    """Advance ``nodes`` through the shared event loop until no work
    remains (or ``t_end``/``max_iters``); returns engine steps executed.
    Thin facade over :class:`EventLoop` for the common one-shot case."""
    return EventLoop(nodes, fleet_policy=fleet_policy, t_end=t_end,
                     max_iters=max_iters, router=router,
                     policy_tick_mode=policy_tick_mode,
                     fault_model=fault_model).run()
