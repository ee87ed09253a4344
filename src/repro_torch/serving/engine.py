"""The inference engine: continuous-batching loop with pluggable execution
backends and a simulated clock.

``SimBackend`` and ``InferenceEngine`` are copies of
``repro.serving.engine``'s, float-op for float-op; ``InferenceEngine``
adds only the hooks of its backend's span trace
(``repro_torch.serving.spans``), which compute nothing the engine reads.
``TorchBackend`` takes the place of ``JaxBackend``: it runs the port's
model on the card (through the Hopper kernels) per iteration, each step
a CUDA graph's replay. Both backends expose identical (latency, energy,
power) effects, so AGFT drives either transparently through
``set_frequency``.

The engine is a discrete-event process: future arrivals live in a heap
(O(log n) ``submit``, no re-sorts), and ``next_event_time`` tells the
event-scheduled driver (``repro_torch.serving.driver``) when this engine next
does anything — now, if the scheduler holds work; at the next arrival, if
it is idle. ``step`` = (idle-advance to that arrival, billing idle energy)
+ ``run_iteration``; both halves are public so event loops can drive them
separately.

Requests reach the arrival heap by one of two paths: ``submit`` (direct
placement, keyed by the request's own arrival time — the historical
instant-materialization model) or ``deliver`` (the routed path: a
:class:`repro_torch.serving.network.NetworkModel` priced the request's network
delivery time and the event loop hands it over on a ROUTE event). A
request routed to this engine but still traversing the network is counted
in ``inflight``; queue-depth telemetry (``requests_waiting``) and router
load (``num_pending``) include it, so a zero-delay network is
indistinguishable — bit-for-bit — from direct submit.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import itertools
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.energy import (A6000, H100, CostModel, DVFSModel,
                                HardwareSpec)
from repro_torch.kernels import build as build_kernels
from repro_torch.models.common import (ModelConfig, resolve_device,
                                       tree_tensors)
from repro_torch.models.registry import build_model
from repro_torch.serving.driver import EngineNode, drive
from repro_torch.serving.graphs import StepGraph
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.metrics import MetricsExporter
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import BatchPlan, ContinuousBatchingScheduler
from repro_torch.serving.spans import SpanTrace


# ---------------------------------------------------------------------------
# Execution backends
# ---------------------------------------------------------------------------

class SimBackend:
    """Analytical backend: iteration cost -> DVFS model -> (dt, energy, W).

    The per-iteration path is a few dozen scalar flops: config-derived cost
    terms live in a precomputed :class:`repro.energy.CostModel`, frequency
    response in the DVFS model's tabulated grid, and batch context means are
    plain Python sums (numpy dispatch overhead dominates at batch size ~8).
    """

    def __init__(self, cfg: ModelConfig, hardware: HardwareSpec = A6000):
        self.cfg = cfg
        self.dvfs = DVFSModel(hardware)
        self.cost = CostModel(cfg)
        self._shared_weight_bytes = 2.0 * self.cost.n_active

    def execute(self, plan: BatchPlan, f_mhz: float
                ) -> Tuple[float, float, float]:
        cost = self.cost
        flops = 0.0
        mem = 0.0
        if plan.prefill:
            s = 0.0
            tok = 0
            for r, n in plan.prefill:
                s += r.prefilled + n / 2
                tok += n
            f1, m1 = cost.iteration_cost(prefill_tokens=tok,
                                         decode_seqs=0,
                                         avg_context=s / len(plan.prefill))
            flops += f1
            mem += m1
        if plan.decode:
            s = 0.0
            for r in plan.decode:
                s += r.prefilled + r.generated       # inlined context_len
            f2, m2 = cost.iteration_cost(prefill_tokens=0,
                                         decode_seqs=len(plan.decode),
                                         avg_context=s / len(plan.decode))
            flops += f2
            # weight reads are shared between the prefill and decode halves
            # of a mixed iteration — don't double count them.
            if plan.prefill:
                m2 -= self._shared_weight_bytes
            mem += max(m2, 0.0)
        t, p = self.dvfs.iteration_time_power(flops, mem, f_mhz)
        return t, p * t, p

    def execute_phased(self, plan: BatchPlan, f_prefill: float,
                       f_decode: float
                       ) -> Tuple[float, float, float, float]:
        """Per-phase pricing of one iteration: the prefill half at
        ``f_prefill``, the decode half at ``f_decode``. Returns
        ``(t_prefill, e_prefill, t_decode, e_decode)``.

        The work split is identical to :meth:`execute` — same two
        ``iteration_cost`` calls, same shared-weight-read subtraction on
        the decode half of a mixed iteration — but each half is priced by
        its own ``iteration_time_power`` call at its phase clock. Each
        half carries its own ``iteration_overhead_s`` (the mid-iteration
        clock switch splits the launch into two dispatches), so a mixed
        iteration at an equal pair is deliberately NOT the same number as
        the single-clock :meth:`execute` — 1-D engines never route through
        this method.
        """
        cost = self.cost
        t_pf = e_pf = t_de = e_de = 0.0
        if plan.prefill:
            s = 0.0
            tok = 0
            for r, n in plan.prefill:
                s += r.prefilled + n / 2
                tok += n
            f1, m1 = cost.iteration_cost(prefill_tokens=tok,
                                         decode_seqs=0,
                                         avg_context=s / len(plan.prefill))
            t, p = self.dvfs.iteration_time_power(f1, m1, f_prefill)
            t_pf, e_pf = t, p * t
        if plan.decode:
            s = 0.0
            for r in plan.decode:
                s += r.prefilled + r.generated       # inlined context_len
            f2, m2 = cost.iteration_cost(prefill_tokens=0,
                                         decode_seqs=len(plan.decode),
                                         avg_context=s / len(plan.decode))
            # weight reads are shared between the halves of a mixed
            # iteration — the decode half re-reads only what the prefill
            # half didn't already stream (same rule as ``execute``)
            if plan.prefill:
                m2 -= self._shared_weight_bytes
            t, p = self.dvfs.iteration_time_power(f2, max(m2, 0.0),
                                                  f_decode)
            t_de, e_de = t, p * t
        return t_pf, e_pf, t_de, e_de

    def execute_mixed_vec(self, prefill_tokens, prefill_count,
                          prefill_ctx_sum, decode_seqs, decode_ctx_sum,
                          terms, hw=None):
        """Batched :meth:`execute` over per-node plan aggregates — the
        mixed prefill+decode pricing of the batched fleet backend's
        admission fast path.

        Each row is one node's iteration: new prompt tokens and the
        context sum over its prefill half (``sum(r.prefilled + n/2)``),
        decode sequence count and context sum, and the node's tabulated
        frequency terms. Elementwise this is the identical float-op
        sequence as the scalar ``execute`` — the two ``iteration_cost``
        calls, the shared-weight-read subtraction on mixed iterations,
        and the same masking as the scalar branches — so per-node
        (dt, energy, power) is bit-for-bit the scalar result.

        ``hw`` optionally carries per-row hardware-constant columns
        (``repro.energy.hw_const_rows`` order) for mixed-hardware fleets;
        the model cost side is fleet-homogeneous either way.
        """
        cost = self.cost
        has_pf = prefill_tokens > 0
        has_de = decode_seqs > 0
        zeros = np.zeros_like(prefill_tokens)
        f1, m1 = cost.iteration_cost_vec(
            prefill_tokens=prefill_tokens, decode_seqs=zeros,
            avg_context=prefill_ctx_sum / np.maximum(prefill_count, 1))
        f2, m2 = cost.iteration_cost_vec(
            prefill_tokens=zeros, decode_seqs=decode_seqs,
            avg_context=decode_ctx_sum / np.maximum(decode_seqs, 1))
        # weight reads are shared between the prefill and decode halves
        # of a mixed iteration — don't double count them (scalar branch:
        # ``if plan.prefill: m2 -= shared``, then ``mem += max(m2, 0)``)
        m2 = np.where(has_pf, m2 - self._shared_weight_bytes, m2)
        m2 = np.maximum(m2, 0.0)
        flops = np.where(has_pf, f1, 0.0) + np.where(has_de, f2, 0.0)
        mem = np.where(has_pf, m1, 0.0) + np.where(has_de, m2, 0.0)
        t, p = self.dvfs.iteration_time_power_vec(flops, mem, terms, hw=hw)
        return t, p * t, p


#: the prefill lengths a backend runs: powers of two up to 64, as
#: ``JaxBackend`` buckets them to bound its traces
PREFILL_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def _decode_body(model, params, token, cache, pos) -> torch.Tensor:
    """One decode step on a backend's static inputs: what its decode graph
    captures. Writes the cache in place; returns the logits."""
    return model.decode_step(params, token, cache, pos)[0]


def _prefill_body(model, params, tokens) -> torch.Tensor:
    """The forward of a prefill bucket's zero tokens: what its graph
    captures."""
    return model.forward(params, tokens)[0]


class TorchBackend:
    """Real-execution backend: runs the port's model on the card per
    iteration and prices energy off measured wall time, the counterpart of
    ``repro.serving.engine.JaxBackend`` with the same behaviour:

    - prefill runs ``forward`` on zero tokens, padded to a bucket of
      ``PREFILL_BUCKETS``, and does not fill the decode cache;
    - decode runs ``decode_step`` at a fixed ``max_batch`` against a cache
      of ``cache_len`` slots, with ``pos`` clamped to ``cache_len - 1``;
      every model writes its cache in place, so ``cache`` keeps its
      tensors from step to step;
    - energy uses ``JaxBackend``'s DVFS formula on the wall time taken
      after ``torch.cuda.synchronize()``; clock control and power stay
      simulated.

    Where ``JaxBackend`` jit-compiles its two steps, this backend captures
    them as CUDA graphs (``repro_torch.serving.graphs.StepGraph``): on the
    card, ``__init__`` builds the kernels and captures the decode step and
    one forward a prefill bucket, all on static inputs (the zero tokens,
    ``pos``, the cache) in one shared memory pool, and ``execute`` writes
    ``pos`` through a pinned host buffer and replays them. A failed capture
    raises. On the CPU, the caller's explicit choice, the same step bodies
    run eagerly.

    The model is built with ``cfg.replace(use_pallas=True)``, so on the card
    every kernel of the model's path (RMSNorm, prefill and decode
    attention, the SSD and RG-LRU scans) goes through the hand-written
    Hopper kernels (on the CPU, their plain versions).
    Weights are random, drawn from ``seed``, unless ``params`` gives them
    (on the backend's device; e.g. converted from the JAX package's by
    ``repro_torch.models.convert.from_jax_params``). There is no
    ``execute_phased``: the engine runs a phased iteration at the dominant
    phase's clock. ``prefill_steps`` and ``decode_steps`` count the
    forwards and decode steps run; ``prefill_lengths`` keeps each forward's
    padded length, ``decode_wall_s`` the wall time of each decode-only
    iteration, and ``logits`` the last decode step's logits. ``trace``
    (``repro_torch.serving.spans.SpanTrace``) records the spans of
    ``execute`` while the engine's iteration is recorded, each replay
    timed on the card by its graph's own events
    (``StepGraph.device_ms``); it counts every ``execute``.
    """

    def __init__(self, cfg: ModelConfig, hardware: HardwareSpec = H100,
                 max_batch: int = 8, cache_len: int = 256, seed: int = 0,
                 device="cuda", params=None):
        if cfg.is_encoder_decoder:
            raise ValueError(
                f"{cfg.name}: TorchBackend serves decoder-only models, as "
                "JaxBackend does; an encoder-decoder runs through its model "
                "contract (prefill with the frames, then decode_step)")
        self.device = resolve_device(device)
        self.cfg = cfg.replace(use_pallas=True)
        self.dvfs = DVFSModel(hardware)
        self.model = build_model(self.cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            with torch.no_grad():
                params = self.model.init(gen)
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.cache = self.model.init_cache(max_batch, cache_len,
                                           device=self.device)
        self.prefill_lengths: List[int] = []
        self.decode_steps = 0
        self.decode_wall_s: List[float] = []
        self.logits: Optional[torch.Tensor] = None
        # the steps' static inputs
        zeros = dict(dtype=torch.long, device=self.device)
        self.token = torch.zeros((max_batch, 1), **zeros)
        self.pos = torch.ones((max_batch,), **zeros)
        self._prefill_tokens = {n: torch.zeros((1, n), **zeros)
                                for n in PREFILL_BUCKETS}
        on_card = self.device.type == "cuda"
        self.trace = SpanTrace()
        self._pos_host = (torch.ones((max_batch,), dtype=torch.long,
                                     pin_memory=True)
                          if on_card else self.pos)
        pool = None
        if on_card:
            build_kernels()
            pool = torch.cuda.graph_pool_handle()
        # the bodies hold the model and its static inputs, not the backend:
        # no reference cycle, so a backend let go frees its memory at once
        with torch.no_grad():
            self.decode_graph = StepGraph(
                functools.partial(_decode_body, self.model, self.params,
                                  self.token, self.cache, self.pos),
                self.device, pool, "decode_step")
            self.prefill_graphs = {
                n: StepGraph(functools.partial(_prefill_body, self.model,
                                               self.params, tokens),
                             self.device, pool, f"forward at {n} tokens")
                for n, tokens in self._prefill_tokens.items()}
        if on_card:
            # the warm-ups stepped the cache: start it from zeros again
            for t in tree_tensors(self.cache):
                t.zero_()
            torch.cuda.synchronize(self.device)

    @property
    def graphs(self) -> List[StepGraph]:
        return [self.decode_graph, *self.prefill_graphs.values()]

    @property
    def prefill_steps(self) -> int:
        return len(self.prefill_lengths)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def execute(self, plan: BatchPlan, f_mhz: float
                ) -> Tuple[float, float, float]:
        tr = self.trace if self.trace.on else None
        if tr is not None:
            t_in = time.perf_counter_ns()
        self._sync()
        if tr is not None:
            tr.child("backend.wait", t_in)
        t0 = time.perf_counter()
        with torch.no_grad():
            if plan.prefill_tokens:
                # bucket prefill lengths to powers of two (zero-pad), as
                # JaxBackend does to bound its traces
                n = min(plan.prefill_tokens, 64)
                n = 1 << (max(n, 1) - 1).bit_length()
                graph = self.prefill_graphs[n]
                if tr is None:
                    graph()
                else:
                    tr.replay("backend.replay.prefill", graph)
                self.prefill_lengths.append(n)
            if plan.decode:
                if tr is not None:
                    t_prep = time.perf_counter_ns()
                b = self.max_batch
                self._pos_host.numpy()[:] = np.minimum(
                    [r.context_len for r in plan.decode[:b]]
                    + [1] * max(0, b - len(plan.decode)), self.cache_len - 1)
                if self._pos_host is not self.pos:
                    self.pos.copy_(self._pos_host, non_blocking=True)
                if tr is None:
                    self.logits = self.decode_graph()
                else:
                    tr.child("backend.prepare", t_prep)
                    self.logits = tr.replay("backend.replay.decode",
                                            self.decode_graph)
                self.decode_steps += 1
        if tr is not None:
            t_sync = time.perf_counter_ns()
        self._sync()
        wall = time.perf_counter() - t0
        if plan.decode and not plan.prefill_tokens:
            self.decode_wall_s.append(wall)
        # price energy with the DVFS power model at measured utilization
        fr = f_mhz / self.dvfs.spec.f_max
        sp = self.dvfs.spec
        p = sp.p_idle + sp.p_static_active + sp.p_dyn_compute * fr ** sp.alpha
        # frequency scales the compute-bound fraction of wall time
        t = wall * (1.0 / max(fr, 1e-3))
        if tr is not None:
            tr.end_execute(t_in, t_sync)
        self.trace.executes += 1
        return t, p * t, p


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EngineConfig:
    num_kv_blocks: int = 4096
    kv_block_size: int = 16
    max_num_seqs: int = 64
    max_batched_tokens: int = 2048
    prefill_chunk: int = 512
    enable_prefix_cache: bool = True


class InferenceEngine:
    def __init__(self, model_cfg: ModelConfig,
                 engine_cfg: Optional[EngineConfig] = None,
                 hardware: HardwareSpec = A6000,
                 backend: Optional[object] = None,
                 initial_frequency: Optional[float] = None):
        self.model_cfg = model_cfg
        self.cfg = engine_cfg or EngineConfig()
        self.hardware = hardware
        self.kv = PagedKVCache(self.cfg.num_kv_blocks,
                               self.cfg.kv_block_size,
                               self.cfg.enable_prefix_cache)
        self.sched = ContinuousBatchingScheduler(
            self.kv, max_num_seqs=self.cfg.max_num_seqs,
            max_batched_tokens=self.cfg.max_batched_tokens,
            prefill_chunk=self.cfg.prefill_chunk)
        self.backend = backend or SimBackend(model_cfg, hardware)
        self.metrics = MetricsExporter()
        self.clock = 0.0
        self.frequency = initial_frequency or hardware.f_max
        #: phase-disaggregated DVFS targets ``(f_prefill, f_decode)`` set
        #: by ``set_phase_frequencies``; None (the default) = classic 1-D
        #: mode, whose iteration path is untouched by phased pricing
        self.freq_targets: Optional[Tuple[float, float]] = None
        # future arrivals: (arrival_time, submit order, request) heap —
        # O(log n) per submit, FIFO among equal arrival times
        self._pending: List[Tuple[float, int, Request]] = []
        self._submit_seq = itertools.count()
        #: requests routed to this engine but still in the network (the
        #: router will ``deliver`` them); counted as waiting load
        self.inflight = 0
        #: per-node fault surface (``repro.serving.faults.NodeFaultState``)
        #: attached by a bound FaultModel; None = healthy simulation, and
        #: every fault hook below is a single None check
        self.fault_state = None
        #: the backend's span trace (``repro_torch.serving.spans``); None
        #: for a backend without one, and every span hook below is then a
        #: single None check
        self.trace = getattr(self.backend, "trace", None)
        self.finished: List[Request] = []

    # ------------------------------------------------------------------
    def submit(self, requests: List[Request]) -> None:
        for r in requests:
            heapq.heappush(self._pending,
                           (r.arrival_time, next(self._submit_seq), r))

    def deliver(self, request: Request, t: float) -> None:
        """Routed-path arrival: the network delivered ``request`` at
        virtual time ``t`` — it becomes schedulable from ``t`` (never
        before its own arrival time), and leaves the in-flight count."""
        heapq.heappush(self._pending,
                       (max(t, request.arrival_time),
                        next(self._submit_seq), request))
        if self.inflight > 0:
            self.inflight -= 1

    def set_frequency(self, f_mhz: float) -> None:
        """Actuate one clock for every phase (the paper's non-invasive 1-D
        boundary). Clears any per-phase targets: a scalar actuation — a
        1-D policy, a band clamp, an operator override — always wins over
        a previously issued phase pair."""
        self.freq_targets = None
        self._apply_frequency(f_mhz)

    def set_phase_frequencies(self, f_prefill: float,
                              f_decode: float) -> None:
        """Phase-disaggregated actuation: run prefill-chunk work at
        ``f_prefill`` and pure-decode work at ``f_decode`` from the next
        iteration on (mixed iterations price each half at its own clock;
        every actual mid-iteration clock change is billed through the
        same ``dvfs_transition_cost`` machinery as a policy actuation).
        Targets are clamped to the hardware envelope and persist until
        ``set_frequency`` reverts the engine to 1-D mode."""
        sp = self.hardware
        self.freq_targets = (
            float(min(max(f_prefill, sp.f_min), sp.f_max)),
            float(min(max(f_decode, sp.f_min), sp.f_max)))

    def _apply_frequency(self, f_mhz: float) -> None:
        """The actual clock switch (fault filter -> clamp -> transition
        billing) — shared by the public 1-D ``set_frequency`` and the
        per-phase switches ``run_iteration`` performs in phased mode."""
        fs = self.fault_state
        if fs is not None:
            # flaky actuation: the call may silently stick (lost) or lag
            # (extra stall billed to the clock); a thermal throttle clamps
            # whatever does land
            eff, stall = fs.filter_set_frequency(f_mhz)
            if eff is None:
                return
            f_mhz = eff
            if stall > 0.0:
                self.clock += stall
        sp = self.hardware
        f = min(max(f_mhz, sp.f_min), sp.f_max)
        if f != self.frequency:
            c = self.metrics.c
            c.freq_transitions_total += 1
            # DVFS transitions are billed when the hardware prices them
            # (both default to 0 in the shipped calibrations)
            if sp.dvfs_transition_cost_j > 0.0:
                c.energy_joules_total += sp.dvfs_transition_cost_j
            if sp.dvfs_transition_s > 0.0:
                self.clock += sp.dvfs_transition_s
        self.frequency = f

    # ------------------------------------------------------------------
    @property
    def pending(self) -> List[Request]:
        """Future arrivals in heap (not time) order — introspection only;
        hot paths use the heap directly."""
        return [r for _, _, r in self._pending]

    @property
    def num_pending(self) -> int:
        """Future arrivals this engine already owns: heap entries plus
        requests still in flight through the network — so router load
        balancing sees the same totals whichever path requests take."""
        return len(self._pending) + self.inflight

    @property
    def next_arrival_time(self) -> Optional[float]:
        return self._pending[0][0] if self._pending else None

    def _ingest_arrivals(self) -> None:
        while self._pending and self._pending[0][0] <= self.clock:
            self.sched.add_request(heapq.heappop(self._pending)[2])

    @property
    def has_work(self) -> bool:
        return bool(self._pending) or self.sched.has_work

    def next_event_time(self) -> Optional[float]:
        """When this engine next does anything: now if the scheduler holds
        work, the next arrival if idle, ``None`` if fully drained."""
        if self.sched.has_work:
            return self.clock
        if self._pending:
            return self._pending[0][0]
        return None

    def advance_to(self, t: float) -> None:
        """Idle-advance the clock to ``t``, billing idle energy for the
        gap, then ingest every arrival now due."""
        dt = max(t - self.clock, 0.0)
        dvfs = getattr(self.backend, "dvfs", None)
        idle_e = dvfs.idle_energy(dt) if dvfs else 0.0
        self.clock = max(self.clock, t)
        self.metrics.c.energy_joules_total += idle_e
        self._ingest_arrivals()

    def step(self) -> List[Request]:
        """One engine iteration; returns requests finished in it. If the
        scheduler is idle, first skips to the next arrival (billing idle
        power for the gap)."""
        self._ingest_arrivals()
        if not self.sched.has_work:
            if not self._pending:
                return []
            self.advance_to(self._pending[0][0])
        return self.run_iteration()

    def _blocked_tick(self) -> List[Request]:
        """Blocked (e.g. out of KV blocks with nothing preemptible): burn a
        millisecond at idle power — time is never free."""
        dt = 1e-3
        dvfs = getattr(self.backend, "dvfs", None)
        if dvfs is not None:
            self.metrics.c.energy_joules_total += dvfs.idle_energy(dt)
        self.clock += dt
        return []

    def _execute_phased(self, plan: BatchPlan
                        ) -> Tuple[float, float, float]:
        """Phase-disaggregated iteration: switch to ``f_prefill`` for the
        prefill half and ``f_decode`` for the decode half (each switch
        runs through ``_apply_frequency``, so fault filtering, clamping
        and DVFS-transition billing apply exactly as for a policy
        actuation), then price each half at the clock that actually
        landed. A mixed iteration ends at the decode clock."""
        f_pf, f_de = self.freq_targets
        ex = getattr(self.backend, "execute_phased", None)
        if ex is None:
            # backend can't split an iteration (e.g. JaxBackend measures
            # one wall time): run the whole batch at the dominant phase's
            # target — decode when any decode work is present
            self._apply_frequency(f_de if plan.decode else f_pf)
            return self.backend.execute(plan, self.frequency)
        if plan.prefill:
            self._apply_frequency(f_pf)
            f_pf = self.frequency        # what the switch actually landed
        if plan.decode:
            self._apply_frequency(f_de)
            f_de = self.frequency
        t_pf, e_pf, t_de, e_de = ex(plan, f_pf, f_de)
        dt = t_pf + t_de
        energy = e_pf + e_de
        return dt, energy, (energy / dt if dt > 0.0 else 0.0)

    def run_iteration(self) -> List[Request]:
        """Execute one continuous-batching iteration at the current clock
        (the scheduler is expected to hold work; otherwise this is a
        blocked tick)."""
        sched = self.sched
        tr = self.trace
        if tr is not None:
            if tr.begin():
                t0 = time.perf_counter_ns()
            else:
                tr = None
        plan = sched.schedule(self.clock)
        if not plan.prefill and not plan.decode:     # inlined plan.empty
            # blocked (e.g. out of KV blocks): try preemption, else idle-tick
            if not sched._preempt_lowest_priority():
                return self._blocked_tick()
            plan = sched.schedule(self.clock)
            if plan.empty:
                return self._blocked_tick()
        if tr is not None:
            t1 = time.perf_counter_ns()

        # prefix-cache credit must be read BEFORE completion advances
        # ``prefilled`` (a request is on its first chunk exactly while
        # prefilled == cached_tokens; evaluating afterwards never matches)
        cached_tok = 0
        for r, _n in plan.prefill:
            if r.cached_tokens and r.prefilled == r.cached_tokens:
                cached_tok += r.cached_tokens

        if self.freq_targets is None:
            dt, energy, power = self.backend.execute(plan, self.frequency)
        else:
            dt, energy, power = self._execute_phased(plan)
        if tr is not None:
            t2 = time.perf_counter_ns()
        self.clock += dt
        finished = sched.complete_iteration(plan, self.clock)
        if finished:
            self.finished.extend(finished)

        # metrics (one pass over the prefill half; comparisons inline the
        # Request properties — hot path)
        prefill_tok = 0
        gen_from_prefill = 0
        for r, n in plan.prefill:
            prefill_tok += n
            if r.prefilled >= r.prompt_len:
                gen_from_prefill += 1
        c = self.metrics.c
        c.prompt_tokens_total += prefill_tok
        c.cached_prompt_tokens_total += cached_tok
        c.generation_tokens_total += len(plan.decode) + gen_from_prefill
        c.iterations_total += 1
        c.requests_finished_total += len(finished)
        c.requests_dropped_total = len(sched.dropped)
        # TTFT is accounted when the scheduler assigns first_token_time —
        # not by replaying a float-equality check against the clock, which
        # could silently drop samples. (Guarded: the event list is empty on
        # almost every iteration — skip the drain call + list churn.)
        if sched._first_token_events:
            for r in sched.pop_first_token_events():
                c.ttft_seconds_total += r.first_token_time - r.arrival_time
                c.ttft_count_total += 1
        stats = self.kv.stats
        c.prefix_cache_hits_total = stats.hits
        c.prefix_cache_queries_total = stats.queries
        c.energy_joules_total += energy
        c.busy_seconds_total += dt
        c.requests_running = len(sched.running)
        # waiting = queued at the scheduler + owned-but-not-yet-ingested,
        # wherever those live (this engine's heap or the network path) —
        # identical totals for direct submit and zero-delay delivery
        c.requests_waiting = (len(sched.waiting) + len(self._pending)
                              + self.inflight)
        c.gpu_cache_usage = self.kv.usage
        c.current_frequency_mhz = self.frequency
        c.current_power_watts = power
        if tr is not None:
            tr.end_iteration(t0, t1, t2)
        return finished

    # ------------------------------------------------------------------
    def run_until(self, t_end: float, policy=None, *, tuner=None) -> None:
        """Advance simulated time to t_end through the shared drive loop,
        invoking the attached policy's ``maybe_act`` on its own cadence.
        (``tuner=`` is a deprecated alias for ``policy=``.)"""
        drive([EngineNode(self, policy if policy is not None else tuner)],
              t_end=t_end)

    def drain(self, policy=None, max_iters: int = 10_000_000, *,
              tuner=None) -> None:
        drive([EngineNode(self, policy if policy is not None else tuner)],
              max_iters=max_iters)
