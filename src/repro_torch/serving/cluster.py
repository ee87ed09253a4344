"""Fleet-level serving (beyond paper — its conclusion targets "LLM
inference clusters"): N engine replicas, each governed by its OWN power
policy (per-node closed loops, no cross-node coordination needed — the
paper's privacy/minimal-intrusion story holds per node), plus a
load-aware router and an optional FLEET-scope controller.

Policies are per-node and heterogeneous: ``policies=["agft", "slo",
None]`` gives node 0 the paper tuner, node 1 a GreenLLM-style SLO
controller, and leaves node 2 at fixed clocks — all driven by the shared
event loop in ``repro_torch.serving.driver``. Because each node learns from its
own fingerprint stream, heterogeneous traffic splits (e.g. a router that
segregates long-context from chat traffic) let different nodes converge
to DIFFERENT frequencies — fleet energy beyond what one global setting
achieves.

``fleet_policy=`` attaches the cross-node coordination baseline instead:
one controller (e.g. ``"global"``) sampling fleet-aggregated telemetry on
FLEET_TICK events and setting a single frequency for every node — the
comparison that quantifies what the per-node closed loops buy
(``benchmarks.tab_fleet``).

Hierarchical control passes BOTH: ``fleet_policy=get_policy("hierarchy",
power_cap_w=...)`` plus per-node ``policies=["agft", ...]`` — the
coordinator water-fills the power budget into per-node frequency bands on
FLEET_TICK and the node loops fine-tune inside them (``repro_torch.policies.
hierarchy``). When the fleet policy declares ``power_cap_w``, the event
loop meters the fleet draw and ``summary()`` reports the budget
accounting (``cap_violation_s``, mean/peak fleet watts).

``network=`` routes requests through a :class:`repro_torch.serving.network.
NetworkModel` (instance, preset name like ``"wan"``, or ``fixed:<ms>``
spec): each submit is priced with per-hop latency + router queueing and
becomes an ARRIVAL *rescheduling* event the event loop delivers at the
request's network delivery time — instead of instant placement at submit
time. Routing decisions still happen at submit in arrival order (the
in-flight count keeps the router's load view identical), so a zero-delay
network is bit-identical to no network at all.

``policy_tick_mode="tick"`` decouples per-node policy decisions from
iteration boundaries: the loop fires per-node POLICY_TICK events on each
policy's sampling period and telemetry windows are cut at tick time. The
default ``"iteration"`` keeps the golden-pinned historical behavior.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import AGFTConfig
from repro_torch.energy import A6000, HardwareSpec, parse_fleet_hardware
from repro_torch.models.common import ModelConfig
from repro_torch.policies import get_policy
from repro_torch.serving.driver import POLICY_TICK_MODES, EngineNode, EventLoop
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.faults import FaultModel
from repro_torch.serving.network import DeliverySchedule, NetworkModel
from repro_torch.serving.request import Request

PolicySpec = Union[str, None, object]   # registry name | None | instance


def route_least_loaded(engines: List[InferenceEngine],
                       req: Request) -> int:
    """Default router: fewest running+waiting requests, normalized by the
    node's peak-throughput scale so the comparison survives mixed fleets
    (an L4 at 3 requests is busier than an H100 at 5 — raw counts are the
    wrong signal across tiers). On a homogeneous fleet every count divides
    by the same positive constant, which preserves the argmin (and its
    ties) exactly — the historical placement is unchanged."""
    loads = [(e.sched.num_running() + e.sched.num_waiting()
              + e.num_pending) / e.hardware.peak_throughput()
             for e in engines]
    return int(np.argmin(loads))


class RoundRobinRouter:
    """Cyclic placement in submit order — the hardware- and load-blind
    baseline the energy-aware router is measured against
    (``benchmarks/tab_hetero.py``). Stateful: construct one per cluster."""

    def __init__(self):
        self._next = 0

    def __call__(self, engines: List[InferenceEngine],
                 req: Request) -> int:
        i = self._next % len(engines)
        self._next = i + 1
        return i


class EnergyAwareRouter:
    """Marginal joules-per-token placement subject to the SLO tier.

    For each candidate node, estimated from the node's own per-spec
    ``CostModel``/``DVFSModel`` at its *current* clock and queue depth:

    * ``est_ttft`` — queueing + prefill delay: the prompt's prefill time
      at the node's current clock, once for each request already queued
      ahead (waiting + pending) plus once for this request;
    * ``jpt`` — marginal joules per generated token: the increase in
      decode-iteration energy from growing the node's decode batch by one
      sequence (joining a busy efficient node rides its amortized weight
      reads; opening an idle node pays them in full), plus the prompt's
      prefill energy amortized over an assumed ``decode_tokens`` output.

    Placement: among nodes whose ``est_ttft`` fits the request's SLO tier
    (``req.deadline_s`` when the workload carries deadlines, else
    ``default_ttft_slo_s``), take the lowest ``jpt``; when no node fits
    the tier, take the lowest ``est_ttft`` (degrade toward least-loaded
    rather than blow the tier everywhere). Both scans break ties to the
    lowest node index, so placement is deterministic under equal costs.
    """

    def __init__(self, default_ttft_slo_s: float = 2.0,
                 decode_tokens: int = 128,
                 avg_context: float = 1024.0):
        self.default_ttft_slo_s = float(default_ttft_slo_s)
        self.decode_tokens = int(decode_tokens)
        self.avg_context = float(avg_context)

    def __call__(self, engines: List[InferenceEngine],
                 req: Request) -> int:
        slo = (req.deadline_s if req.deadline_s is not None
               else self.default_ttft_slo_s)
        d_tok = self.decode_tokens
        best_i, best_jpt = -1, float("inf")
        fb_i, fb_wait = 0, float("inf")
        for i, e in enumerate(engines):
            dvfs = e.backend.dvfs
            cost = e.backend.cost
            f = e.frequency
            q_ahead = (e.sched.num_waiting() + e.num_pending)
            d0 = e.sched.num_running()
            fp, mp = cost.iteration_cost(
                prefill_tokens=req.prompt_len, decode_seqs=0,
                avg_context=req.prompt_len / 2)
            t_pf, p_pf = dvfs.iteration_time_power(fp, mp, f)
            est_ttft = (q_ahead + 1) * t_pf
            fd1, md1 = cost.iteration_cost(
                prefill_tokens=0, decode_seqs=d0 + 1,
                avg_context=self.avg_context)
            t1, p1 = dvfs.iteration_time_power(fd1, md1, f)
            if d0 > 0:
                fd0, md0 = cost.iteration_cost(
                    prefill_tokens=0, decode_seqs=d0,
                    avg_context=self.avg_context)
                t0, p0 = dvfs.iteration_time_power(fd0, md0, f)
                de = p1 * t1 - p0 * t0
                if de <= 0.0:
                    # marginal degenerates (equal-cost plateau): fall back
                    # to the node's average joules per decoded token
                    de = p1 * t1 / (d0 + 1)
            else:
                de = p1 * t1
            jpt = (p_pf * t_pf + d_tok * de) / d_tok
            if est_ttft <= slo and jpt < best_jpt:
                best_i, best_jpt = i, jpt
            if est_ttft < fb_wait:
                fb_i, fb_wait = i, est_ttft
        return best_i if best_i >= 0 else fb_i


#: Router factory registry: names accepted by ``ServingCluster(router=)``
#: and ``launch.serve --router``. Factories, not instances — stateful
#: routers must not leak placement state across clusters.
ROUTERS = {
    "least-loaded": lambda: route_least_loaded,
    "length": lambda: route_by_length,
    "round-robin": RoundRobinRouter,
    "energy": EnergyAwareRouter,
}


def make_router(name: str) -> Callable:
    key = str(name).strip().lower()
    if key not in ROUTERS:
        raise ValueError(f"unknown router {name!r}; registry has "
                         f"{sorted(ROUTERS)}")
    return ROUTERS[key]()


def route_by_length(engines: List[InferenceEngine], req: Request) -> int:
    """Segregating router: long-context traffic to the first half of the
    fleet, short/chat traffic to the second half (workload-homogeneous
    nodes converge faster and to better-fitting frequencies)."""
    n = len(engines)
    half = max(n // 2, 1)
    if req.prompt_len >= 1024:
        pool = range(0, half)
    else:
        pool = range(half, n) if n > 1 else range(0, 1)
    loads = {i: engines[i].sched.num_running() + engines[i].sched.num_waiting()
             for i in pool}
    return min(loads, key=loads.get)


@dataclasses.dataclass
class ClusterSummary:
    energy_j: float
    finished: int
    mean_ttft_s: float
    mean_tpot_s: float
    edp: float
    node_frequencies: List[float]
    node_energy_j: List[float]
    # hardware-tier accounting (mixed fleets; single-tier fleets get one
    # entry). ``energy_by_tier`` maps spec name -> joules, and
    # ``finished_by_tier`` counts completions per tier so joules/request
    # per tier falls out directly.
    node_hardware: Optional[List[str]] = None
    energy_by_tier: Optional[dict] = None
    finished_by_tier: Optional[dict] = None
    # power-budget accounting (None unless the attached fleet policy
    # declares power_cap_w — see repro_torch.policies.hierarchy)
    power_cap_w: Optional[float] = None
    cap_violation_s: Optional[float] = None
    metered_s: Optional[float] = None
    mean_fleet_power_w: Optional[float] = None
    peak_fleet_power_w: Optional[float] = None
    # routing-path accounting (None unless a network model is attached)
    mean_net_delay_s: Optional[float] = None
    max_net_delay_s: Optional[float] = None
    # robustness accounting (always present; non-trivial only under
    # fault injection / deadlines — see repro_torch.serving.faults)
    submitted: int = 0
    dropped_total: int = 0
    completion_rate: float = 1.0
    fault_counters: Optional[dict] = None


class ServingCluster:
    def __init__(self, model_cfg: ModelConfig, n_nodes: int = 2, *,
                 hardware: Union[HardwareSpec, str,
                                 Sequence[HardwareSpec]] = A6000,
                 engine_cfg: Optional[EngineConfig] = None,
                 tuner_cfg: Optional[AGFTConfig] = None,
                 with_tuners: bool = True,
                 policies: Optional[Sequence[PolicySpec]] = None,
                 router: Union[Callable, str] = route_least_loaded,
                 fleet_policy: PolicySpec = None,
                 network: Union[NetworkModel, str, None] = None,
                 faults: Union[FaultModel, str, None] = None,
                 fault_seed: int = 0,
                 policy_tick_mode: str = "iteration",
                 step_mode: str = "event",
                 batched_record_history: bool = True,
                 batched_train_cap: Optional[int] = None,
                 batched_classb_path: str = "vector"):
        """``policies`` takes one entry per node — a registry name, a
        ready policy instance, or None (fixed clocks). When omitted,
        ``with_tuners`` keeps the legacy behaviour: an AGFT tuner per node
        (``tuner_cfg`` applies) or no policy at all. ``fleet_policy``
        attaches a FLEET-scope controller instead (registry name like
        ``"global"`` or instance); per-node policies then default to None
        so exactly one authority actuates each node (pass both explicitly
        for hierarchical experiments). ``network`` prices each submit's
        routing path (NetworkModel instance, preset name, or
        ``fixed:<ms>`` spec) and turns placement into delayed delivery;
        ``faults`` attaches a seeded fault-injection model
        (:class:`repro_torch.serving.faults.FaultModel` instance, preset name
        like ``"node-churn"``, or the clause spec grammar — ``fault_seed``
        seeds a string spec); ``policy_tick_mode`` picks iteration-gated
        (default) or pure wall-clock POLICY_TICK policy scheduling.

        ``step_mode`` selects the drain backend: ``"event"`` (default)
        is the per-event heap loop; ``"batched"`` steps the fleet
        through :class:`repro_torch.serving.fleet_step.BatchedFleetLoop` —
        structure-of-arrays state, vectorized decode physics, batched
        LinUCB decisions — with bit-identical per-node trajectories
        (see that module for the exact contract and the unsupported
        shapes, e.g. network models). ``batched_record_history`` can
        drop per-decision tuner history on the batched path, the main
        residual per-node Python cost at mega-fleet scale;
        ``batched_train_cap`` overrides the decode-train length cap
        (``BatchedFleetLoop.TRAIN_CAP``), and ``batched_classb_path``
        selects the admission path (``"vector"`` default, ``"engine"``
        for the real-step fallback).

        ``hardware`` describes the fleet's accelerators: one spec or
        registry name (homogeneous, the historical form), a per-node spec
        list (``hardware=[A6000, H100, L4]``), or a fleet spec string
        (``hardware="a6000,h100:2,l4"``). Per-node policies resolve
        against their own node's spec; mixed fleets hand fleet policies
        the full per-node list (the hierarchy coordinator water-fills
        through per-spec power curves), and ``router`` may be a registry
        name from :data:`ROUTERS` (``"energy"``, ``"least-loaded"``,
        ``"round-robin"``, ``"length"``) or any callable."""
        hw_list = parse_fleet_hardware(hardware, n_nodes)
        self.hardware = hw_list
        hetero = any(hw != hw_list[0] for hw in hw_list)
        engines = [InferenceEngine(model_cfg,
                                   engine_cfg or EngineConfig(),
                                   hardware=hw,
                                   initial_frequency=hw.f_max)
                   for hw in hw_list]
        if isinstance(fleet_policy, str):
            fleet_policy = get_policy(
                fleet_policy,
                hardware=hw_list if hetero else hw_list[0])
        if (fleet_policy is not None
                and getattr(fleet_policy, "scope", "node") != "fleet"):
            raise ValueError(
                f"fleet_policy must have scope 'fleet', got "
                f"{type(fleet_policy).__name__} (scope "
                f"{getattr(fleet_policy, 'scope', 'node')!r})")
        self.fleet_policy = fleet_policy
        if policies is None:
            policies = (["agft"] * n_nodes
                        if with_tuners and fleet_policy is None
                        else [None] * n_nodes)
        if len(policies) != n_nodes:
            raise ValueError(f"got {len(policies)} policies for "
                             f"{n_nodes} nodes")
        resolved = []
        for node_hw, spec in zip(hw_list, policies):
            if isinstance(spec, str):
                kw = ({"cfg": tuner_cfg}
                      if spec == "agft" and tuner_cfg is not None else {})
                spec = get_policy(spec, hardware=node_hw, **kw)
            if spec is not None and getattr(spec, "scope", "node") == "fleet":
                raise ValueError(
                    f"{type(spec).__name__} is fleet-scope; attach it via "
                    f"fleet_policy=, not per-node policies")
            resolved.append(spec)
        self.nodes = [EngineNode(e, p) for e, p in zip(engines, resolved)]
        self.router = make_router(router) if isinstance(router, str) \
            else router
        if isinstance(network, str):
            network = NetworkModel.from_spec(network)
        self.network = network
        if policy_tick_mode not in POLICY_TICK_MODES:
            raise ValueError(
                f"policy_tick_mode must be one of {POLICY_TICK_MODES}, "
                f"got {policy_tick_mode!r}")
        self.policy_tick_mode = policy_tick_mode
        if isinstance(faults, str):
            faults = FaultModel.from_spec(faults, seed=fault_seed)
        if faults is not None and not faults.active:
            faults = None                  # the "none" preset: healthy
        self.faults = faults
        if faults is not None:
            faults.bind(engines)
            faults.network = self.network
            # crash re-routes reuse the cluster router, restricted to the
            # surviving subset (the loop's least-loaded fallback applies
            # when the installed router is the default anyway)
            cluster_router = self.router

            def _route_up(engs, req, up):
                return up[cluster_router([engs[i] for i in up], req)]

            faults.route = _route_up
        if step_mode not in ("event", "batched"):
            raise ValueError(f"step_mode must be 'event' or 'batched', "
                             f"got {step_mode!r}")
        if step_mode == "batched" and network is not None:
            raise NotImplementedError(
                "step_mode='batched' does not support a network model "
                "(in-flight routed deliveries need the event heap)")
        if step_mode == "batched" and faults is not None:
            raise NotImplementedError(
                "step_mode='batched' does not support an active fault "
                "model (crash evacuation and re-routing need the event "
                "heap)")
        self.step_mode = step_mode
        self.batched_record_history = batched_record_history
        self.batched_train_cap = batched_train_cap
        self.batched_classb_path = batched_classb_path
        # priced deliveries awaiting their ROUTE event; persists across
        # drains so run_until-style repeated draining keeps consuming it
        # (crash re-routes need the pipe even without a network model)
        self._deliveries = (DeliverySchedule()
                            if network is not None or faults is not None
                            else None)
        self.submitted = 0
        self._loop: Optional[EventLoop] = None   # last drain's event loop

    # ------------------------------------------------------------------
    @property
    def engines(self) -> List[InferenceEngine]:
        return [n.engine for n in self.nodes]

    @property
    def policies(self) -> List[Optional[object]]:
        return [n.policy for n in self.nodes]

    #: legacy alias from the AGFT-only era
    tuners = policies

    # ------------------------------------------------------------------
    def submit(self, requests: List[Request]) -> None:
        """Route each request at its arrival time (arrival order). With a
        network model attached, placement is deferred: the request's
        routing path is priced (hops + router queueing) and the event
        loop delivers it to its engine at the network delivery time — the
        engine's in-flight counter keeps the router's load view identical
        to the direct path meanwhile."""
        engines = self.engines
        net = self.network
        fm = self.faults
        self.submitted += len(requests)
        for req in sorted(requests, key=lambda r: r.arrival_time):
            if fm is not None:
                # never place on a node currently known dark (mid-drain
                # submits; before the first drain every node is up)
                idx = fm.pick_node(engines, req)
            else:
                idx = self.router(engines, req)
            if net is None:
                engines[idx].submit([req])
            else:
                req.delivery_time = net.delivery_time(req.arrival_time)
                engines[idx].inflight += 1
                self._deliveries.push(req.delivery_time, idx, req)

    @property
    def has_work(self) -> bool:
        return (any(n.engine.has_work for n in self.nodes)
                or bool(self._deliveries))

    def drain(self, max_iters: int = 10_000_000) -> int:
        """Advance all nodes through the shared event loop (events fire in
        virtual-time order; nodes are independent, so per-node
        trajectories don't depend on interleaving). A fleet policy, if
        attached, ticks on its own cadence against the loop's global
        timeline; the loop is kept so ``summary()`` can surface its
        power-budget accounting. In-flight routed requests ride along as
        ROUTE events.

        With ``step_mode="batched"`` the fleet advances through the
        structure-of-arrays :class:`repro_torch.serving.fleet_step.
        BatchedFleetLoop` instead — same trajectories, same ``summary()``
        accounting, minutes instead of hours at mega-fleet scale."""
        if self.step_mode == "batched":
            from repro_torch.serving.fleet_step import BatchedFleetLoop
            self._loop = BatchedFleetLoop(
                self.nodes, fleet_policy=self.fleet_policy,
                max_iters=max_iters,
                policy_tick_mode=self.policy_tick_mode,
                record_history=self.batched_record_history,
                train_cap=self.batched_train_cap,
                classb_path=self.batched_classb_path)
        else:
            self._loop = EventLoop(self.nodes,
                                   fleet_policy=self.fleet_policy,
                                   max_iters=max_iters,
                                   router=self._deliveries,
                                   policy_tick_mode=self.policy_tick_mode,
                                   fault_model=self.faults)
        return self._loop.run()

    # ------------------------------------------------------------------
    def summary(self) -> ClusterSummary:
        engines = self.engines
        fin = [r for e in engines for r in e.finished]
        tpots = [r.tpot for r in fin if r.tpot is not None]
        energy = sum(e.metrics.c.energy_joules_total for e in engines)
        tpot = float(np.mean(tpots)) if tpots else 0.0
        out = ClusterSummary(
            energy_j=energy,
            finished=len(fin),
            mean_ttft_s=float(np.mean([r.ttft for r in fin])) if fin else 0,
            mean_tpot_s=tpot,
            edp=energy * tpot,
            node_frequencies=[e.frequency for e in engines],
            node_energy_j=[e.metrics.c.energy_joules_total
                           for e in engines],
        )
        # per-hardware-tier accounting: joules and completions grouped by
        # spec name (trivially one group on a homogeneous fleet)
        out.node_hardware = [e.hardware.name for e in engines]
        energy_by_tier: dict = {}
        finished_by_tier: dict = {}
        for e in engines:
            tier = e.hardware.name
            energy_by_tier[tier] = (energy_by_tier.get(tier, 0.0)
                                    + e.metrics.c.energy_joules_total)
            finished_by_tier[tier] = (finished_by_tier.get(tier, 0)
                                      + len(e.finished))
        out.energy_by_tier = energy_by_tier
        out.finished_by_tier = finished_by_tier
        loop = self._loop
        if loop is not None and loop._power_cap is not None:
            out.power_cap_w = loop._power_cap
            out.cap_violation_s = loop.cap_violation_s
            out.metered_s = loop.metered_s
            out.mean_fleet_power_w = loop.mean_fleet_power_w
            out.peak_fleet_power_w = loop.peak_fleet_power_w
        if self.network is not None:
            delays = [r.net_delay for r in fin if r.net_delay is not None]
            out.mean_net_delay_s = float(np.mean(delays)) if delays else 0.0
            out.max_net_delay_s = float(np.max(delays)) if delays else 0.0
        # robustness accounting: deadline sheds always count; retry-
        # budget drops and fault counters require an attached model
        out.submitted = self.submitted
        out.dropped_total = sum(len(e.sched.dropped) for e in engines)
        if self.faults is not None:
            out.dropped_total += self.faults.drops
            out.fault_counters = self.faults.counters()
        served = max(out.submitted - out.dropped_total, 1)
        out.completion_rate = (len(fin) / served
                               if out.submitted > 0 else 1.0)
        return out
