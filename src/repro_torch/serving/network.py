"""Routing-path network model: requests no longer teleport to engines.

The discrete-event core (``repro_torch.serving.driver``) historically placed a
routed request into its engine's arrival heap at ``submit`` time — the
request materialized at the node the instant the client emitted it. Real
clusters interpose a routing path: a client→router hop, FIFO queueing at
the router (one dispatch pipeline, finite service rate), and a
router→node hop. SLO-aware DVFS work (GreenLLM, arXiv:2508.16449;
switching-aware bandits, arXiv:2410.11855) shows the telemetry a tuner
sees — queue depths, TTFT pressure — shifts materially once that delay
exists, so the event core must model it to evaluate policies honestly.

:class:`NetworkModel` prices the path per request, deterministically:

    t_router  = arrival + hop()                (client -> router)
    t_dispatch= max(t_router, router_free) + router_service_s
    delivery  = t_dispatch + hop()             (router -> node)

``hop()`` samples the configured per-hop latency distribution
(``constant`` / ``uniform`` / ``lognormal``) from a seeded
``numpy.random.default_rng`` stream consumed in submit order, so a given
(trace, seed) always prices identically. Router queueing is closed-form
FIFO (``router_free`` carries the dispatch pipe's busy horizon), so burst
arrivals see queue waits even when hops are constant.

A zero-configured model (all latencies 0) prices every request at its
arrival time exactly — ``delivery == arrival`` bit-for-bit — which is the
equivalence the property suite pins: routing through the network event
path with zero delay is byte-identical to direct submit.

:class:`DeliverySchedule` is the router's event-source half: the priced
``(delivery_time, node, request)`` entries live in ITS heap, and the
event loop pops them as ``ROUTE`` events — arrivals are *rescheduled*
onto engines at delivery time instead of placed at submit time. The
schedule outlives a single ``EventLoop`` (``run_until``-style repeated
drains keep consuming it).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

#: distribution names accepted by :class:`NetworkModel`
DISTRIBUTIONS = ("constant", "uniform", "lognormal")


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Static description of one routing path (all times in seconds)."""
    #: mean one-way per-hop latency; two hops per request (client->router,
    #: router->node). 0 disables hop delay entirely.
    hop_latency_s: float = 0.0
    #: per-request router service time — the FIFO dispatch pipe; bursts
    #: arriving faster than 1/service queue up. 0 disables queueing.
    router_service_s: float = 0.0
    #: per-hop latency distribution: "constant" | "uniform" | "lognormal"
    distribution: str = "constant"
    #: dispersion as a fraction of the mean: uniform half-width or
    #: lognormal coefficient of variation. Ignored by "constant".
    jitter: float = 0.0

    @property
    def mean_delay_s(self) -> float:
        """Expected unqueued routing delay (two hops + one service)."""
        return 2.0 * self.hop_latency_s + self.router_service_s


#: named calibrations for the CLI / benchmarks (mean end-to-end routing
#: delay in parentheses): "zero" is the equivalence configuration, the
#: others bracket same-rack to cross-region serving.
PRESETS: Dict[str, NetworkConfig] = {
    "zero": NetworkConfig(),
    "lan": NetworkConfig(hop_latency_s=150e-6, router_service_s=50e-6,
                         distribution="lognormal", jitter=0.3),   # ~350 us
    "datacenter": NetworkConfig(hop_latency_s=2.5e-3,
                                router_service_s=200e-6,
                                distribution="lognormal",
                                jitter=0.4),                      # ~5 ms
    "wan": NetworkConfig(hop_latency_s=24e-3, router_service_s=200e-6,
                         distribution="lognormal", jitter=0.25),  # ~50 ms
}


class NetworkModel:
    """Seeded, stateful pricer of the routing path (see module docstring).

    One instance prices one cluster's ingress in submit order; the hop
    RNG stream and the router-queue horizon are the only state, so two
    models constructed with identical config+seed price identical traces
    identically — the determinism every golden/property test leans on.
    """

    def __init__(self, config: Optional[NetworkConfig] = None, *,
                 seed: int = 0, **overrides):
        if config is None:
            config = NetworkConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        if config.distribution not in DISTRIBUTIONS:
            raise ValueError(
                f"unknown distribution {config.distribution!r}; choose "
                f"from {', '.join(DISTRIBUTIONS)}")
        if config.hop_latency_s < 0 or config.router_service_s < 0:
            raise ValueError("network latencies must be >= 0")
        self.config = config
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._router_free = 0.0          # dispatch pipe busy horizon
        # lognormal(mu, sigma) parameterized to the configured mean/cv
        cv = max(config.jitter, 0.0)
        self._ln_sigma = math.sqrt(math.log1p(cv * cv))
        self._ln_mu = (math.log(config.hop_latency_s)
                       - 0.5 * self._ln_sigma ** 2
                       if config.hop_latency_s > 0 else 0.0)

    @classmethod
    def from_spec(cls, spec: str, *, seed: int = 0) -> "NetworkModel":
        """Build from a CLI spec: a preset name (``zero``/``lan``/
        ``datacenter``/``wan``) or ``fixed:<millis>`` for a constant
        total routing delay of ``<millis>`` ms."""
        if spec in PRESETS:
            return cls(PRESETS[spec], seed=seed)
        if spec.startswith("fixed:"):
            ms = float(spec.split(":", 1)[1])
            if ms < 0:
                raise ValueError("fixed network delay must be >= 0")
            return cls(NetworkConfig(hop_latency_s=ms * 1e-3 / 2.0),
                       seed=seed)
        raise ValueError(f"unknown network spec {spec!r}; presets: "
                         f"{', '.join(sorted(PRESETS))} or fixed:<ms>")

    # ------------------------------------------------------------------
    def _hop(self) -> float:
        c = self.config
        if c.hop_latency_s <= 0.0:
            return 0.0
        if c.distribution == "constant" or c.jitter <= 0.0:
            return c.hop_latency_s
        if c.distribution == "uniform":
            half = c.jitter * c.hop_latency_s
            return float(self._rng.uniform(
                max(c.hop_latency_s - half, 0.0), c.hop_latency_s + half))
        return float(self._rng.lognormal(self._ln_mu, self._ln_sigma))

    def delivery_time(self, arrival_time: float) -> float:
        """Price one request's routing path; advances the router-queue
        horizon. Call in submit (arrival) order. With a zero-configured
        model this returns ``arrival_time`` exactly."""
        c = self.config
        if c.hop_latency_s <= 0.0 and c.router_service_s <= 0.0:
            return arrival_time          # exact: no float detour
        t_router = arrival_time + self._hop()
        if c.router_service_s > 0.0:
            start = max(t_router, self._router_free)
            self._router_free = start + c.router_service_s
            t_router = self._router_free
        return t_router + self._hop()


class DeliverySchedule:
    """The router's event-source heap: priced deliveries awaiting their
    ROUTE event. ``repro_torch.serving.driver.EventLoop`` pops due entries and
    hands each request to its engine at delivery time."""

    def __init__(self):
        self._heap: List[Tuple[float, int, int, object]] = []
        self._seq = itertools.count()    # FIFO among equal delivery times

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, delivery_time: float, node_index: int,
             request) -> None:
        heapq.heappush(self._heap, (delivery_time, next(self._seq),
                                    node_index, request))

    def next_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def first_time_per_node(self) -> Dict[int, float]:
        """Earliest scheduled delivery per node index — the event loop
        anchors a node's POLICY_TICK train where the node first gets
        work, matching the direct path's first-arrival anchor."""
        first: Dict[int, float] = {}
        for t, _, node, _ in self._heap:
            if node not in first or t < first[node]:
                first[node] = t
        return first

    def extract_node(self, node_index: int) -> List[Tuple[float, object]]:
        """Remove and return every in-flight delivery addressed to
        ``node_index``, in (delivery time, submit) order — the crash path
        (``repro_torch.serving.faults``): requests still traversing the network
        toward a node that just died are pulled back and re-routed
        instead of delivered into the void. The surviving entries keep
        their order exactly."""
        if not self._heap:
            return []
        mine = [(t, s, req) for t, s, node, req in self._heap
                if node == node_index]
        if not mine:
            return []
        keep = [e for e in self._heap if e[2] != node_index]
        self._heap = keep
        heapq.heapify(keep)
        mine.sort()
        return [(t, req) for t, _, req in mine]

    def pop_due(self, t: float) -> List[Tuple[int, object]]:
        """All deliveries with ``delivery_time <= t``, in (time, submit)
        order — one ROUTE event delivers every request due at its
        instant, so a node's revival event is never scheduled between
        two same-time deliveries."""
        out = []
        while self._heap and self._heap[0][0] <= t:
            _, _, node, req = heapq.heappop(self._heap)
            out.append((node, req))
        return out
