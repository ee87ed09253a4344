"""Batched mega-fleet stepping: structure-of-arrays state, event-horizon
sync, vectorized decode physics — ``ServingCluster(step_mode="batched")``.

The event loop (``repro_torch.serving.driver``) pays a heap round-trip and a
Python engine iteration per node event; at fleet scale (1000+ nodes over
an Azure trace day, ~10^8-10^9 node steps) that is hours of pure
interpreter overhead. This backend keeps the *real* ``InferenceEngine``
objects as the source of truth for discrete state (scheduler queues, KV
cache, request objects) but mirrors every numeric scalar the hot path
touches — clock, frequency, energy, the 17 telemetry counters/gauges,
queue depths, decode context sums — into stacked numpy arrays, and steps
the whole fleet in rounds:

* **classA** (the overwhelming majority of steps in decode-heavy serving):
  nodes whose next iteration is a pure decode batch — running sequences
  only, nothing waiting, nothing prefilling, no arrival due. One numpy
  dispatch prices *all* such nodes' iterations at once through the same
  ``CostModel.iteration_cost_vec`` / ``DVFSModel.iteration_time_power_vec``
  expressions the scalar backend uses (verified bit-identical); request
  finishes are precomputed into per-node ``(finish_iteration, admission
  order)`` heaps so per-request Python runs only on the iterations where
  a request actually completes.
* **classB** (everything else — arrivals, admission, chunked prefill,
  KV-pressure blocked ticks): a three-phase vectorized admission path
  (``_step_classb``). Discrete pre-work runs against the real engine
  objects — arrival ingest, the scheduler's own ``_admit`` (so admission
  order and prefix-cache LRU/stats mutations, failed ``try_allocate``
  side effects included, are exactly the per-event loop's), plan
  selection over mirrored running-order prefill lists — then all nodes'
  mixed prefill+decode iterations are priced in one batched
  ``SimBackend.execute_mixed_vec`` dispatch, and completion (TTFT
  assignment, ``register_prefix``, finish-heap joins, blocked ticks) is
  replayed per node in the scalar engine's exact order. No real
  ``engine.step()`` runs on this path (the ``classb_engine_steps``
  counter stays 0; ``classb_path="engine"`` retains the old
  flush/step/refresh fallback for bisection). Preemption is provably
  unreachable under the ``max_num_seqs <= max_batched_tokens`` guard:
  every running request contributes to the plan, so an empty plan means
  an empty running set and only blocked idle-ticks remain structural.

Decisions run through :class:`repro_torch.core.stacked.StackedAGFT` (one numpy
dispatch per stage for every node due this round) when the fleet is
batchable — otherwise each policy sees a per-node facade whose
reads/actuations are backed by the arrays, so arbitrary policies work
unchanged (slower). Fleet-scope policies fire at event horizons: nodes
step while their next event is strictly before the horizon ``T``, then
the fleet tick fires at ``T`` against fully flushed engines.

Equivalence contract (gated by ``tests/test_fleet_step.py``): per-node
trajectories — clocks, energies, all exported counters, finished-request
timestamps, tuner decisions and bank state — are **bit-identical** to
``EventLoop`` in both ``policy_tick_mode`` settings. Documented
measure-zero exceptions, all requiring exact float coincidences that
generated workloads do not produce:

* a FLEET_TICK and a node event at the *exact same* float instant may
  order differently (the loop steps nodes strictly before the horizon);
* a POLICY_TICK coinciding exactly with a node's event time fires after
  that step in both backends, but an arrival landing exactly on a tick
  boundary of an idle node may order differently.

``max_iters`` is honored exactly: when the remaining budget no longer
covers one step per eligible node, the loop falls back to strict
event-time single-stepping and stops on the exact step count, like
``EventLoop.run`` (under truncation the *allocation* of the final steps
across nodes follows event order, which for multi-node fleets matches
the event loop's heap order up to same-instant ties).

Heterogeneous *hardware* fleets are supported: each node carries its own
``HardwareSpec`` (frequency-terms table per node; power/overhead scalars
as per-node constant columns through the vectorized physics), and the
result is bit-identical to the per-event loop on mixed fleets just as on
homogeneous ones. Mixed AGFT fleets automatically take the facade path
(``StackedAGFT.from_tuners`` refuses differing frequency grids).

Unsupported shapes raise ``NotImplementedError`` at construction: network
routing (in-flight deliveries), fleet policy + tick mode, non-Sim
backends, heterogeneous *model* configs, an engine whose backend DVFS
spec disagrees with its hardware, ``max_num_seqs > max_batched_tokens``
(the decode-every-iteration invariant the finish heaps rely on), an
active fault model (crash evacuation and re-routing need the event
heap), and phase-disaggregated engines or policies (``freq_targets`` /
``phased = True`` — per-phase clocks need the per-event pricing path;
see ``repro_torch.policies.phased``).
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.stacked import StackedAGFT
from repro_torch.serving.driver import (DEFAULT_FLEET_TICK_PERIOD_S,
                                  POLICY_TICK_MODES, EngineNode,
                                  _policy_period)
from repro_torch.energy.power_model import hw_const_rows
from repro_torch.serving.engine import SimBackend
from repro_torch.serving.request import RequestState

#: sentinel "no finish pending" iteration index (far beyond any run)
_BIG = 1 << 62


class _NodeFacade:
    """Engine stand-in handed to per-node policies on the facade path:
    reads come from the batched arrays, ``set_frequency`` goes through
    the loop's batched transition billing. Exposes exactly the policy-
    visible surface (the privacy boundary): clock, frequency, hardware,
    and ``metrics.snapshot()``."""

    __slots__ = ("_loop", "_i")

    def __init__(self, loop: "BatchedFleetLoop", i: int):
        self._loop = loop
        self._i = i

    @property
    def clock(self) -> float:
        return float(self._loop.clock[self._i])

    @property
    def frequency(self) -> float:
        return float(self._loop.freq[self._i])

    @property
    def hardware(self):
        return self._loop.specs[self._i]

    @property
    def metrics(self) -> "_NodeFacade":
        return self

    def snapshot(self) -> dict:
        return self._loop._snapshot_dict(self._i)

    def set_frequency(self, f_mhz: float) -> None:
        self._loop._set_frequency_one(self._i, f_mhz)


class BatchedFleetLoop:
    """Drop-in for :class:`repro_torch.serving.driver.EventLoop` over fleets of
    simulated engines sharing one model config — per-node hardware may
    differ (see module docstring). ``run()`` returns the number of engine
    steps, like ``EventLoop.run``."""

    def __init__(self, nodes: Sequence[EngineNode], *,
                 fleet_policy: Optional[object] = None,
                 max_iters: int = 10_000_000,
                 policy_tick_mode: str = "iteration",
                 decisions: str = "auto",
                 record_history: bool = True,
                 train_cap: Optional[int] = None,
                 classb_path: str = "vector"):
        if policy_tick_mode not in POLICY_TICK_MODES:
            raise ValueError(
                f"policy_tick_mode must be one of {POLICY_TICK_MODES}, "
                f"got {policy_tick_mode!r}")
        if decisions not in ("auto", "stacked", "facade"):
            raise ValueError("decisions must be 'auto', 'stacked' or "
                             f"'facade', got {decisions!r}")
        if classb_path not in ("vector", "engine"):
            raise ValueError("classb_path must be 'vector' or 'engine', "
                             f"got {classb_path!r}")
        self.train_cap = int(train_cap) if train_cap is not None \
            else self.TRAIN_CAP
        if self.train_cap < 1:
            raise ValueError(f"train_cap must be >= 1, got {train_cap}")
        self.classb_path = classb_path
        self.nodes = list(nodes)
        self.engines = [nd.engine for nd in self.nodes]
        self.policies = [nd.policy for nd in self.nodes]
        n = len(self.engines)
        if n == 0:
            raise ValueError("BatchedFleetLoop needs at least one node")
        e0 = self.engines[0]
        if not isinstance(e0.backend, SimBackend):
            raise NotImplementedError(
                "step_mode='batched' requires SimBackend engines")
        self.hw = e0.hardware
        self.dvfs = e0.backend.dvfs
        self.cost = e0.backend.cost
        for eng in self.engines:
            if not isinstance(eng.backend, SimBackend):
                raise NotImplementedError(
                    "step_mode='batched' requires SimBackend engines")
            if eng.backend.dvfs.spec != eng.hardware:
                raise NotImplementedError(
                    "step_mode='batched' requires each engine's backend "
                    "DVFS spec to match its hardware (mixed specs are "
                    "fine; a mismatched engine is not)")
            if (eng.backend.cost.cfg != self.cost.cfg
                    or eng.backend.cost.bytes_per_el
                    != self.cost.bytes_per_el):
                raise NotImplementedError(
                    "step_mode='batched' requires a homogeneous fleet "
                    "(identical ModelConfig on every node)")
            if eng.cfg.max_num_seqs > eng.cfg.max_batched_tokens:
                raise NotImplementedError(
                    "step_mode='batched' requires max_num_seqs <= "
                    "max_batched_tokens (every running decode must fit "
                    "each iteration's token budget)")
            if getattr(eng, "inflight", 0):
                raise NotImplementedError(
                    "step_mode='batched' does not support in-flight "
                    "routed requests (network models)")
            if getattr(eng, "fault_state", None) is not None:
                raise NotImplementedError(
                    "step_mode='batched' does not support an active "
                    "fault model (crash evacuation and re-routing need "
                    "the event heap)")
            if getattr(eng, "freq_targets", None) is not None:
                raise NotImplementedError(
                    "step_mode='batched' does not support phase-"
                    "disaggregated engines (per-phase clocks need the "
                    "per-event pricing path; use step_mode='events')")
        for pol in self.policies:
            if getattr(pol, "phased", False):
                raise NotImplementedError(
                    "step_mode='batched' does not support phased "
                    "policies (agft-2d / greenllm-rule actuate "
                    "set_phase_frequencies; use step_mode='events')")
        self.fleet_policy = fleet_policy
        self.max_iters = max_iters
        self.policy_tick_mode = policy_tick_mode
        self._tick_mode = policy_tick_mode == "tick"
        if fleet_policy is not None and self._tick_mode:
            raise NotImplementedError(
                "step_mode='batched' does not support a fleet policy "
                "together with policy_tick_mode='tick'")
        self.n = n
        self.steps = 0
        self.now = 0.0
        self._round_hook = None          # test instrumentation: f(loop)
        self.backend = e0.backend        # model-homogeneity-checked above
        # --- per-node hardware (mixed fleets) -------------------------
        # The frequency-response terms table is per-node (each node's own
        # DVFSModel memo), and the power/overhead scalars become per-node
        # constant columns threaded through the vectorized physics. On a
        # homogeneous fleet every row holds the same values the scalar
        # constants held, so the arithmetic is bit-identical.
        self.specs = [eng.hardware for eng in self.engines]
        self.dvfs_by_node = [eng.backend.dvfs for eng in self.engines]
        self.hetero = any(sp != self.hw for sp in self.specs)
        self.hw_consts = hw_const_rows(self.specs)
        self.f_min_col = np.array([sp.f_min for sp in self.specs])
        self.f_max_col = np.array([sp.f_max for sp in self.specs])
        self.trans_j_col = np.array(
            [sp.dvfs_transition_cost_j for sp in self.specs])
        self.trans_s_col = np.array(
            [sp.dvfs_transition_s for sp in self.specs])
        self.p_idle_col = self.hw_consts[:, 0]
        #: real ``engine.step()`` calls (the retired classB fallback —
        #: stays 0 on the default vectorized path) and total admissions,
        #: so benchmarks can report real-steps-per-admitted-request
        self.classb_engine_steps = 0
        self.classb_fast_steps = 0
        self.admitted_requests = 0

        # --- stacked numeric state (mirrors of engine scalars) --------
        f8, i8 = np.float64, np.int64
        self.clock = np.zeros(n, f8)
        self.freq = np.zeros(n, f8)
        self.terms = np.zeros((n, 3), f8)
        self.energy = np.zeros(n, f8)
        self.busy = np.zeros(n, f8)
        self.prompt_tok = np.zeros(n, i8)
        self.cached_tok = np.zeros(n, i8)
        self.gen_tok = np.zeros(n, i8)
        self.iters = np.zeros(n, i8)
        self.fin_cnt = np.zeros(n, i8)
        self.hits = np.zeros(n, i8)
        self.queries = np.zeros(n, i8)
        self.ttft_sum = np.zeros(n, f8)
        self.ttft_cnt = np.zeros(n, i8)
        self.trans = np.zeros(n, i8)
        self.g_run = np.zeros(n, i8)
        self.g_wait = np.zeros(n, i8)
        self.g_usage = np.zeros(n, f8)
        self.g_freq = np.zeros(n, f8)
        self.g_pow = np.zeros(n, f8)
        self.usage = np.zeros(n, f8)
        # scheduler mirrors
        self.R = np.zeros(n, i8)         # len(running)
        self.W = np.zeros(n, i8)         # len(waiting)
        self.P = np.zeros(n, i8)         # prefilling rows among running
        self.D = np.zeros(n, i8)         # decode rows (R - P)
        self.S_ctx = np.zeros(n, i8)     # sum(prefilled+generated) decodes
        self.pend = np.zeros(n, i8)      # len(engine._pending)
        self.next_arrival = np.full(n, np.inf)
        # finish bookkeeping: per-node heap of (finish_iter, adm_seq, req)
        self.next_fin = np.full(n, _BIG, i8)
        self._heaps: List[list] = [[] for _ in range(n)]
        self._fin_map: List[dict] = [{} for _ in range(n)]
        self._adm_seq: List[dict] = [{} for _ in range(n)]
        self._adm_ctr = [0] * n
        # running-order prefilling requests per node — the scheduler's
        # chunk-pass order, maintained so admission plans never rescan
        # the running dict
        self._prefilling: List[list] = [[] for _ in range(n)]
        # engine-side staleness: dirty => arrays lead the engine object
        self.dirty = np.zeros(n, bool)
        self.gen_dirty = np.zeros(n, bool)

        for i in range(n):
            self._refresh(i)

        # --- decisions ------------------------------------------------
        self.stacked: Optional[StackedAGFT] = None
        if decisions in ("auto", "stacked") and fleet_policy is None \
                and all(p is not None for p in self.policies):
            self.stacked = StackedAGFT.from_tuners(
                self.policies, record_history=record_history)
        if decisions == "stacked" and self.stacked is None:
            raise ValueError(
                "decisions='stacked' but the fleet is not batchable "
                "(see StackedAGFT.from_tuners) or a fleet policy is "
                "attached")
        self._facades = (None if self.stacked is not None else
                         [_NodeFacade(self, i) for i in range(n)])

        # --- policy ticks (tick mode) ---------------------------------
        nev0 = np.where((self.R > 0) | (self.W > 0), self.clock,
                        self.next_arrival)
        if self._tick_mode:
            self.tick_period = np.zeros(n, f8)
            self.next_tick = np.full(n, np.inf)
            self.tick_alive = np.zeros(n, bool)
            for i in range(n):
                if self.policies[i] is None:
                    continue
                self.tick_period[i] = _policy_period(self.policies[i])
                if np.isfinite(nev0[i]):
                    # first tick anchors at the node's first event time
                    self.next_tick[i] = nev0[i]
                    self.tick_alive[i] = True

        # --- fleet ticks + power metering -----------------------------
        self._T: Optional[float] = None
        self._power_cap = getattr(fleet_policy, "power_cap_w", None)
        self.cap_violation_s = 0.0
        self.metered_s = 0.0
        self.metered_energy_j = 0.0
        self.peak_fleet_power_w = 0.0
        self._meter_t = 0.0
        self._meter_e = 0.0
        if fleet_policy is not None:
            self._fleet_period = getattr(fleet_policy, "sampling_period_s",
                                         DEFAULT_FLEET_TICK_PERIOD_S)
            if np.isfinite(nev0).any():
                start = float(nev0[np.isfinite(nev0)].min())
                self._meter_t = start
                self._meter_e = self._fleet_energy_j()
                init = getattr(fleet_policy, "initial_bands", None)
                if init is not None:
                    self._propagate_bands(init(self.engines))
                    for i in range(n):
                        self._refresh_actuation(i)
                self._T = start + self._fleet_period

    # ------------------------------------------------------------------
    # engine <-> array synchronization
    # ------------------------------------------------------------------
    def _refresh(self, i: int) -> None:
        """Re-mirror node ``i``'s engine into its array row (after a real
        ``engine.step()``, or at construction)."""
        eng = self.engines[i]
        c = eng.metrics.c
        self.clock[i] = eng.clock
        f = eng.frequency
        if f != self.freq[i] or not self.terms[i].any():
            self.freq[i] = f
            self.terms[i] = self.dvfs_by_node[i]._freq_terms(float(f))
        self.prompt_tok[i] = c.prompt_tokens_total
        self.cached_tok[i] = c.cached_prompt_tokens_total
        self.gen_tok[i] = c.generation_tokens_total
        self.iters[i] = c.iterations_total
        self.fin_cnt[i] = c.requests_finished_total
        self.hits[i] = c.prefix_cache_hits_total
        self.queries[i] = c.prefix_cache_queries_total
        self.energy[i] = c.energy_joules_total
        self.busy[i] = c.busy_seconds_total
        self.ttft_sum[i] = c.ttft_seconds_total
        self.ttft_cnt[i] = c.ttft_count_total
        self.trans[i] = c.freq_transitions_total
        self.g_run[i] = c.requests_running
        self.g_wait[i] = c.requests_waiting
        self.g_usage[i] = c.gpu_cache_usage
        self.g_freq[i] = c.current_frequency_mhz
        self.g_pow[i] = c.current_power_watts
        self.usage[i] = eng.kv.usage
        sched = eng.sched
        self.W[i] = len(sched.waiting)
        self.pend[i] = len(eng._pending)
        self.next_arrival[i] = (eng._pending[0][0] if eng._pending
                                else np.inf)
        heap = self._heaps[i]
        fmap = self._fin_map[i]
        aseq = self._adm_seq[i]
        ctr = self._adm_ctr[i]
        it = c.iterations_total
        pl = []
        S = 0
        for req in sched.running.values():
            rid = req.request_id
            sq = aseq.get(rid)
            if sq is None:
                # admission sequence: first-seen order over the running
                # dict == insertion order == the scheduler's decode plan
                # order, so same-iteration finishers pop in plan order
                aseq[rid] = sq = ctr
                ctr += 1
                self.admitted_requests += 1
            if req.prefilled < req.prompt_len:
                pl.append(req)
            else:
                S += req.prefilled + req.generated
                if rid not in fmap:
                    # decodes one token per iteration from here on (the
                    # max_num_seqs <= max_batched_tokens guard), so the
                    # finish iteration is fixed at join time
                    fin = it + req.output_len - req.generated
                    fmap[rid] = fin
                    heapq.heappush(heap, (fin, sq, req))
        self._adm_ctr[i] = ctr
        self._prefilling[i] = pl
        self.R[i] = len(sched.running)
        self.P[i] = len(pl)
        self.D[i] = self.R[i] - len(pl)
        self.S_ctx[i] = S
        # lazily drop entries whose request finished through a real step
        while heap and heap[0][2].state is RequestState.FINISHED:
            _, _, req = heapq.heappop(heap)
            fmap.pop(req.request_id, None)
            aseq.pop(req.request_id, None)
        self.next_fin[i] = heap[0][0] if heap else _BIG
        self.dirty[i] = False
        self.gen_dirty[i] = False

    def _flush(self, i: int) -> None:
        """Write node ``i``'s array row back into its engine (before a
        real step, a fleet tick, or at run end). No-op when the engine
        already matches (no vectorized activity since last sync)."""
        if not self.dirty[i]:
            return
        eng = self.engines[i]
        eng.clock = float(self.clock[i])
        eng.frequency = float(self.freq[i])
        c = eng.metrics.c
        c.prompt_tokens_total = int(self.prompt_tok[i])
        c.cached_prompt_tokens_total = int(self.cached_tok[i])
        c.generation_tokens_total = int(self.gen_tok[i])
        c.iterations_total = int(self.iters[i])
        c.requests_finished_total = int(self.fin_cnt[i])
        c.prefix_cache_hits_total = int(self.hits[i])
        c.prefix_cache_queries_total = int(self.queries[i])
        c.energy_joules_total = float(self.energy[i])
        c.busy_seconds_total = float(self.busy[i])
        c.ttft_seconds_total = float(self.ttft_sum[i])
        c.ttft_count_total = int(self.ttft_cnt[i])
        c.freq_transitions_total = int(self.trans[i])
        c.requests_running = int(self.g_run[i])
        c.requests_waiting = int(self.g_wait[i])
        c.gpu_cache_usage = float(self.g_usage[i])
        c.current_frequency_mhz = float(self.g_freq[i])
        c.current_power_watts = float(self.g_pow[i])
        if self.gen_dirty[i]:
            run_d = eng.sched.running
            it = int(self.iters[i])
            for rid, fin in self._fin_map[i].items():
                req = run_d.get(rid)
                if req is not None:
                    req.generated = req.output_len - (fin - it)
            self.gen_dirty[i] = False
        self.dirty[i] = False

    def _refresh_actuation(self, i: int) -> None:
        """Light re-mirror after real-engine actuation (fleet ticks call
        ``set_frequency`` on real engines): only clock / frequency /
        energy / transition count can have moved."""
        eng = self.engines[i]
        c = eng.metrics.c
        self.clock[i] = eng.clock
        self.energy[i] = c.energy_joules_total
        self.trans[i] = c.freq_transitions_total
        f = eng.frequency
        if f != self.freq[i]:
            self.freq[i] = f
            self.terms[i] = self.dvfs_by_node[i]._freq_terms(float(f))

    # ------------------------------------------------------------------
    # telemetry views
    # ------------------------------------------------------------------
    def _snap_matrix(self, idx: np.ndarray) -> np.ndarray:
        """Rows of ``MetricsExporter.snapshot()`` values in ``SNAP_KEYS``
        order for the nodes in ``idx`` — the StackedAGFT input."""
        m = np.empty((len(idx), 17))
        m[:, 0] = self.prompt_tok[idx]
        m[:, 1] = self.cached_tok[idx]
        m[:, 2] = self.gen_tok[idx]
        m[:, 3] = self.iters[idx]
        m[:, 4] = self.fin_cnt[idx]
        m[:, 5] = self.hits[idx]
        m[:, 6] = self.queries[idx]
        m[:, 7] = self.energy[idx]
        m[:, 8] = self.busy[idx]
        m[:, 9] = self.ttft_sum[idx]
        m[:, 10] = self.ttft_cnt[idx]
        m[:, 11] = self.trans[idx]
        m[:, 12] = self.g_run[idx]
        m[:, 13] = self.g_wait[idx]
        m[:, 14] = self.g_usage[idx]
        m[:, 15] = self.g_freq[idx]
        m[:, 16] = self.g_pow[idx]
        return m

    def _snapshot_dict(self, i: int) -> dict:
        """A single node's snapshot as the exporter dict (facade path)."""
        return {
            "vllm:prompt_tokens_total": int(self.prompt_tok[i]),
            "vllm:cached_prompt_tokens_total": int(self.cached_tok[i]),
            "vllm:generation_tokens_total": int(self.gen_tok[i]),
            "vllm:iterations_total": int(self.iters[i]),
            "vllm:requests_finished_total": int(self.fin_cnt[i]),
            "vllm:prefix_cache_hits_total": int(self.hits[i]),
            "vllm:prefix_cache_queries_total": int(self.queries[i]),
            "vllm:energy_joules_total": float(self.energy[i]),
            "vllm:busy_seconds_total": float(self.busy[i]),
            "vllm:ttft_seconds_total": float(self.ttft_sum[i]),
            "vllm:ttft_count_total": int(self.ttft_cnt[i]),
            "vllm:freq_transitions_total": int(self.trans[i]),
            "vllm:num_requests_running": int(self.g_run[i]),
            "vllm:num_requests_waiting": int(self.g_wait[i]),
            "vllm:gpu_cache_usage_perc": float(self.g_usage[i]),
            "vllm:current_frequency_mhz": float(self.g_freq[i]),
            "vllm:current_power_watts": float(self.g_pow[i]),
        }

    # ------------------------------------------------------------------
    # actuation (engine.set_frequency semantics over arrays)
    # ------------------------------------------------------------------
    def _actuate(self, idx: np.ndarray, f: np.ndarray) -> None:
        # Per-node clamp and transition billing: on a homogeneous fleet
        # every column holds the scalar spec's value, and adding a 0.0
        # transition cost is a bitwise no-op for the non-negative energy
        # and clock accumulators, so this is the identical arithmetic the
        # scalar-spec version performed.
        f = np.minimum(np.maximum(f, self.f_min_col[idx]),
                       self.f_max_col[idx])
        ch = f != self.freq[idx]
        if ch.any():
            chi = idx[ch]
            self.trans[chi] += 1
            self.energy[chi] += self.trans_j_col[chi]
            self.clock[chi] += self.trans_s_col[chi]
            fch = f[ch]
            for j, i in enumerate(chi.tolist()):
                self.terms[i] = self.dvfs_by_node[i]._freq_terms(
                    float(fch[j]))
            self.dirty[chi] = True
        self.freq[idx] = f

    def _set_frequency_one(self, i: int, f_mhz: float) -> None:
        sp = self.specs[i]
        f = min(max(f_mhz, sp.f_min), sp.f_max)
        if f != self.freq[i]:
            self.trans[i] += 1
            if sp.dvfs_transition_cost_j > 0.0:
                self.energy[i] += sp.dvfs_transition_cost_j
            if sp.dvfs_transition_s > 0.0:
                self.clock[i] += sp.dvfs_transition_s
            self.terms[i] = self.dvfs_by_node[i]._freq_terms(float(f))
            self.dirty[i] = True
        self.freq[i] = f

    def _iter_hook(self, idx: np.ndarray, f: np.ndarray) -> np.ndarray:
        """StackedAGFT actuation hook, iteration mode: apply the batched
        ``set_frequency`` and hand back the POST-transition clocks — the
        scalar tuner's history records ``engine.clock`` after actuation."""
        self._actuate(idx, f)
        return self.clock[idx].copy()

    def _tick_hook(self, idx: np.ndarray, f: np.ndarray) -> None:
        """Tick-mode hook: actuate, but history keeps the tick times."""
        self._actuate(idx, f)
        return None

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    #: max decode iterations advanced per node per round. Horizon cuts
    #: (arrival / policy due / finish / fleet tick) bound trains anyway;
    #: the cap bounds wasted speculative physics past a cut. Measured on
    #: the 1000-node Azure day replay (``benchmarks/tab_megafleet.py
    #: --train-cap sweep``, 1h slice): 64 beats 8 by ~20% and 256 by
    #: ~16% node-iterations/sec — small caps pay per-round dispatch
    #: overhead more often, large caps price physics past the typical
    #: ~2s policy horizon that then gets thrown away.
    TRAIN_CAP = 64

    def _policy_horizon(self, idx: np.ndarray) -> np.ndarray:
        """Per-node next policy-decision time for the nodes in ``idx`` —
        the iteration-mode train cut. ``inf`` = no policy; ``-inf`` =
        opaque policy (can't see its sampler), forcing 1-step trains so
        ``maybe_act`` still runs after every iteration."""
        if self.stacked is not None:
            return self.stacked.next_sample[idx]
        ns = np.empty(len(idx))
        for j, i in enumerate(idx.tolist()):
            pol = self.policies[i]
            if pol is None:
                ns[j] = np.inf
            else:
                ns[j] = getattr(getattr(pol, "monitor", None),
                                "next_sample", -np.inf)
        return ns

    def _step_trains(self, idx: np.ndarray, cap: int) -> int:
        """Advance every pure-decode node in ``idx`` by a *train* of up
        to ``cap`` consecutive iterations, cut at its next event horizon:
        request finish, pending arrival, policy decision (sample due /
        tick), or fleet tick. Within a train nothing discrete happens, so
        the whole trajectory is computable up front — the vectorized
        mirror of repeated ``run_iteration`` + ``SimBackend.execute``
        all-decode steps. Clock/energy/busy accumulate through a
        leading-element ``cumsum`` (numpy's axis-1 cumsum is the
        sequential left fold), so every intermediate value is
        bit-identical to the scalar ``+=`` chain. Returns the number of
        engine steps taken."""
        k_n = len(idx)
        m = np.minimum(self.next_fin[idx] - self.iters[idx], cap)
        Mm = int(m.max())
        D = self.D[idx]
        S = (self.S_ctx[idx][:, None]
             + D[:, None] * np.arange(Mm, dtype=np.int64)[None, :])
        avg = S / D[:, None]
        flops, mem = self.cost.iteration_cost_vec(
            prefill_tokens=np.zeros((k_n, 1), np.int64),
            decode_seqs=D[:, None], avg_context=avg)
        mem = np.maximum(mem, 0.0)
        t, p = self.dvfs.iteration_time_power_vec(
            flops, mem, self.terms[idx][:, None, :],
            hw=self.hw_consts[idx][:, None, :])
        cat = np.empty((k_n, Mm + 1))
        cat[:, 0] = self.clock[idx]
        cat[:, 1:] = t
        c = np.cumsum(cat, axis=1)
        # arrival + fleet horizon: iteration j+1 runs iff its start clock
        # c[:, j] is still before the horizon (the event loop pops the
        # earlier event otherwise)
        k_cut = np.sum(c[:, :Mm] < self.next_arrival[idx][:, None],
                       axis=1)
        if self._T is not None:
            k_cut = np.minimum(k_cut, np.sum(c[:, :Mm] < self._T, axis=1))
        if self._tick_mode:
            # a POLICY_TICK at tau fires only strictly before the next
            # node event: iteration j+1 (at c[:, j]) still runs when
            # tau >= c[:, j]
            if Mm > 1:
                tau = self.next_tick[idx]
                k_cut = np.minimum(
                    k_cut, 1 + np.sum(tau[:, None] >= c[:, 1:Mm], axis=1))
            else:
                k_cut = np.minimum(k_cut, 1)
        else:
            # iteration mode checks maybe_act after EVERY step: stop at
            # the first iteration whose end clock crosses next_sample
            ns = self._policy_horizon(idx)
            if Mm > 1:
                k_cut = np.minimum(
                    k_cut, 1 + np.sum(c[:, 1:Mm] < ns[:, None], axis=1))
            else:
                k_cut = np.minimum(k_cut, 1)
        k = np.minimum(m, k_cut)
        rows = np.arange(k_n)
        self.clock[idx] = c[rows, k]
        cat[:, 1:] = p * t
        cat[:, 0] = self.energy[idx]
        self.energy[idx] = np.cumsum(cat, axis=1)[rows, k]
        cat[:, 1:] = t
        cat[:, 0] = self.busy[idx]
        self.busy[idx] = np.cumsum(cat, axis=1)[rows, k]
        self.gen_tok[idx] += D * k
        self.iters[idx] += k
        self.S_ctx[idx] += D * k
        fin_due = self.next_fin[idx] == self.iters[idx]
        if fin_due.any():
            for i in idx[fin_due].tolist():
                self._process_finishers(i)
        self.g_run[idx] = self.R[idx]
        self.g_wait[idx] = self.pend[idx]
        self.g_usage[idx] = self.usage[idx]
        self.g_freq[idx] = self.freq[idx]
        self.g_pow[idx] = p[rows, k - 1]
        self.dirty[idx] = True
        self.gen_dirty[idx] = True
        return int(k.sum())

    def _process_finishers(self, i: int) -> None:
        """Complete every request whose precomputed finish iteration is
        due on node ``i`` — the per-request tail of the scheduler's
        ``complete_iteration`` (state, finish_time, running-dict removal,
        KV free) in decode-plan order."""
        eng = self.engines[i]
        run_d = eng.sched.running
        kv = eng.kv
        heap = self._heaps[i]
        fmap = self._fin_map[i]
        aseq = self._adm_seq[i]
        it = int(self.iters[i])
        clk = float(self.clock[i])
        n_f = 0
        while heap and heap[0][0] <= it:
            fin, _, req = heapq.heappop(heap)
            rid = req.request_id
            if req.state is RequestState.FINISHED or fmap.get(rid) != fin:
                fmap.pop(rid, None)
                aseq.pop(rid, None)
                continue
            req.generated = req.output_len
            req.state = RequestState.FINISHED
            req.finish_time = clk
            del run_d[rid]
            del fmap[rid]
            aseq.pop(rid, None)
            kv.free(req)
            eng.finished.append(req)
            self.S_ctx[i] -= req.prefilled + req.output_len
            n_f += 1
        self.R[i] -= n_f
        self.D[i] -= n_f
        self.fin_cnt[i] += n_f
        self.usage[i] = kv.usage
        self.next_fin[i] = heap[0][0] if heap else _BIG

    def _step_py(self, i: int) -> None:
        """One real engine step for node ``i`` — the retired classB
        fallback, kept behind ``classb_path='engine'`` for bisection and
        the equivalence suite's cross-check of the vectorized path."""
        self.classb_engine_steps += 1
        self._flush(i)
        self.engines[i].step()
        self._refresh(i)

    def _step_classb(self, b_idx: np.ndarray) -> int:
        """One engine iteration for every structural node in ``b_idx`` —
        arrivals, admission, chunked prefill, blocked ticks — with **no**
        real ``engine.step()`` calls. Three phases:

        1. per-node discrete pre-work against the real engine objects:
           arrival ingest, idle-advance billing, the scheduler's own
           ``_admit`` (so prefix-cache ``try_allocate`` side effects —
           stats and LRU motion on failure included — are the event
           loop's by construction), and plan selection over the mirrored
           running-order prefill lists;
        2. one batched ``SimBackend.execute_mixed_vec`` dispatch pricing
           every node's mixed prefill+decode iteration;
        3. per-node completion replay in the scalar engine's exact order:
           chunk advancement, first-token assignment + TTFT accounting,
           ``register_prefix``, instant finishers, then decode-finish
           heap joins and ``_process_finishers``.

        Preemption is unreachable here: with ``max_num_seqs <=
        max_batched_tokens`` every running request contributes to the
        plan, so an empty plan means an empty running set and the scalar
        engine's preemption scan is a guaranteed no-op before its blocked
        tick. Returns the number of engine steps taken (== len(b_idx);
        blocked ticks are steps too)."""
        p_idle_l = self.p_idle_col
        r_node: List[int] = []
        r_clk: List[float] = []
        r_pf: List[list] = []
        r_pf_tok: List[int] = []
        r_pf_cnt: List[int] = []
        r_pf_ctx: List[float] = []
        r_ctok: List[int] = []
        r_dec: List[int] = []
        r_dctx: List[int] = []
        r_newdec: List[list] = []
        inf = np.inf
        clk_a = self.clock[b_idx].tolist()
        D_a = self.D[b_idx].tolist()
        S_a = self.S_ctx[b_idx].tolist()
        for k, i in enumerate(b_idx.tolist()):
            eng = self.engines[i]
            sched = eng.sched
            pend = eng._pending
            add = sched.add_request
            clk = clk_a[k]
            while pend and pend[0][0] <= clk:
                add(heapq.heappop(pend)[2])
            if not (sched.running or sched.waiting):
                # idle engine: ``step`` advances to the next arrival,
                # billing idle energy for the gap (advance_to semantics)
                t_arr = pend[0][0]
                dt = t_arr - clk
                if dt < 0.0:
                    dt = 0.0
                self.energy[i] += p_idle_l[i] * dt
                if t_arr > clk:
                    clk = t_arr
                while pend and pend[0][0] <= clk:
                    add(heapq.heappop(pend)[2])
            # _admit's own first move is this same emptiness check; doing
            # it here skips the call entirely on no-queue steps
            admitted = sched._admit(clk) if sched.waiting else ()
            newdec: list = ()
            if admitted:
                aseq = self._adm_seq[i]
                ctr = self._adm_ctr[i]
                pl = self._prefilling[i]
                newdec = []
                for req in admitted:
                    aseq[req.request_id] = ctr
                    ctr += 1
                    if req.prefilled < req.prompt_len:
                        pl.append(req)
                    else:
                        newdec.append(req)     # fully prefix-cached
                self._adm_ctr[i] = ctr
                self.admitted_requests += len(admitted)
            # the scheduler's batch pass: every running decode fits (the
            # max_num_seqs <= max_batched_tokens guard), then chunked
            # prefill over the running-order prefilling mirror
            dec_n = D_a[k] + len(newdec)
            dctx = S_a[k]
            for req in newdec:
                dctx += req.prefilled          # generated == 0 here
            budget = sched.max_batched_tokens - dec_n
            chunk_cap = sched.prefill_chunk
            pf: list = []
            pf_tok = 0
            pf_ctx = 0.0
            ctok = 0
            for req in self._prefilling[i]:
                if budget <= 0:
                    break
                chunk = req.prompt_len - req.prefilled
                if chunk > chunk_cap:
                    chunk = chunk_cap
                if chunk > budget:
                    chunk = budget
                pf.append((req, chunk))
                pf_tok += chunk
                # prefix-cache credit is read while the request sits on
                # its first chunk, exactly as run_iteration's pre-execute
                # pass does
                if req.cached_tokens and req.prefilled == req.cached_tokens:
                    ctok += req.cached_tokens
                pf_ctx += req.prefilled + chunk / 2
                budget -= chunk
            if not pf and not dec_n:
                # empty plan <=> empty running set (see docstring): the
                # engine burns a blocked millisecond at idle power — no
                # metric writes, only the classification mirrors move
                self.energy[i] += p_idle_l[i] * 1e-3
                self.clock[i] = clk + 1e-3
                self.W[i] = len(sched.waiting)
                self.pend[i] = len(pend)
                self.next_arrival[i] = pend[0][0] if pend else inf
                self.dirty[i] = True
                continue
            r_node.append(i)
            r_clk.append(clk)
            r_pf.append(pf)
            r_pf_tok.append(pf_tok)
            r_pf_cnt.append(len(pf))
            r_pf_ctx.append(pf_ctx)
            r_ctok.append(ctok)
            r_dec.append(dec_n)
            r_dctx.append(dctx)
            r_newdec.append(newdec)

        steps = len(b_idx)
        self.classb_fast_steps += steps
        if not r_node:
            return steps
        rows = np.asarray(r_node, np.int64)
        pf_tok_v = np.asarray(r_pf_tok, np.int64)
        dec_v = np.asarray(r_dec, np.int64)
        t_v, e_v, p_v = self.backend.execute_mixed_vec(
            pf_tok_v, np.asarray(r_pf_cnt, np.int64),
            np.asarray(r_pf_ctx), dec_v,
            np.asarray(r_dctx, np.int64), self.terms[rows],
            hw=self.hw_consts[rows])

        # completion replay accumulates its per-row counter outcomes in
        # plain lists and commits them as one scatter per array below —
        # the per-row loop touches only real objects (requests, heaps,
        # the scheduler) plus the rare TTFT accumulators. The elementwise
        # arithmetic (int sums, one f8 add per element on unique rows)
        # is the scalar writes' exactly.
        finished_state = RequestState.FINISHED
        clk_v = np.asarray(r_clk) + t_v
        clk_l = clk_v.tolist()
        it_v = self.iters[rows] + 1
        it_l = it_v.tolist()
        gen_pf_l: List[int] = []
        n_fin_l: List[int] = []
        n_join_l: List[int] = []
        join_ctx_l: List[int] = []
        nf_l: List[int] = []
        R_l: List[int] = []
        P_l: List[int] = []
        W_l: List[int] = []
        npend_l: List[int] = []
        narr_l: List[float] = []
        hits_l: List[int] = []
        q_l: List[int] = []
        usage_l: List[float] = []
        for j, i in enumerate(r_node):
            eng = self.engines[i]
            sched = eng.sched
            kv = eng.kv
            pend = eng._pending
            clk = clk_l[j]
            it = it_l[j]
            heap = self._heaps[i]
            fmap = self._fin_map[i]
            aseq = self._adm_seq[i]
            gen_pf = 0
            n_join = 0
            join_ctx = 0
            fin_pf: list = ()
            pf = r_pf[j]
            if pf:
                completed = False
                for req, chunk in pf:
                    req.prefilled += chunk
                    if req.prefilled >= req.prompt_len:
                        # prompt done -> first output token this iter
                        completed = True
                        gen_pf += 1
                        req.generated += 1
                        if req.first_token_time is None:
                            req.first_token_time = clk
                            self.ttft_sum[i] += clk - req.arrival_time
                            self.ttft_cnt[i] += 1
                        kv.register_prefix(req)
                        if req.generated >= req.output_len:
                            if fin_pf == ():
                                fin_pf = []
                            fin_pf.append(req)
                        else:
                            rid = req.request_id
                            fin = it + req.output_len - req.generated
                            fmap[rid] = fin
                            heapq.heappush(heap, (fin, aseq[rid], req))
                            n_join += 1
                            join_ctx += req.prefilled + req.generated
                if completed:
                    self._prefilling[i] = [
                        r for r in self._prefilling[i]
                        if r.prefilled < r.prompt_len]
                if fin_pf:
                    # the scalar finished loop runs after both plan
                    # halves; prefill finishers free their KV before the
                    # decode finishers (matched by _process_finishers
                    # running below)
                    run_d = sched.running
                    done = eng.finished
                    for req in fin_pf:
                        rid = req.request_id
                        req.state = finished_state
                        req.finish_time = clk
                        del run_d[rid]
                        aseq.pop(rid, None)
                        kv.free(req)
                        done.append(req)
            for req in r_newdec[j]:
                # admitted fully-cached: decodes from this very
                # iteration, so the finish iteration is fixed now;
                # ``generated`` stays implicit (reconstructed by _flush
                # from the finish map, like train decodes)
                rid = req.request_id
                fin = it + req.output_len - 1
                fmap[rid] = fin
                heapq.heappush(heap, (fin, aseq[rid], req))
            gen_pf_l.append(gen_pf)
            n_fin_l.append(len(fin_pf))
            n_join_l.append(n_join)
            join_ctx_l.append(join_ctx)
            nf_l.append(heap[0][0] if heap else _BIG)
            R_l.append(len(sched.running))
            P_l.append(len(self._prefilling[i]))
            W_l.append(len(sched.waiting))
            n_p = len(pend)
            npend_l.append(n_p)
            narr_l.append(pend[0][0] if n_p else inf)
            st = kv.stats
            hits_l.append(st.hits)
            q_l.append(st.queries)
            usage_l.append(kv.usage)
        nf_v = np.asarray(nf_l, np.int64)
        n_fin_v = np.asarray(n_fin_l, np.int64)
        w_v = np.asarray(W_l, np.int64)
        npend_v = np.asarray(npend_l, np.int64)
        self.clock[rows] = clk_v
        self.energy[rows] += e_v
        self.busy[rows] += t_v
        self.prompt_tok[rows] += pf_tok_v
        self.cached_tok[rows] += np.asarray(r_ctok, np.int64)
        self.gen_tok[rows] += dec_v + np.asarray(gen_pf_l, np.int64)
        self.iters[rows] = it_v
        self.fin_cnt[rows] += n_fin_v
        self.hits[rows] = hits_l
        self.queries[rows] = q_l
        # decode contexts grew by one token each; prefill completers
        # join the decode pool at their post-iteration context
        self.S_ctx[rows] = np.asarray(r_dctx, np.int64) + dec_v \
            + np.asarray(join_ctx_l, np.int64)
        self.D[rows] = dec_v + np.asarray(n_join_l, np.int64)
        self.R[rows] = R_l
        self.P[rows] = P_l
        self.W[rows] = w_v
        self.pend[rows] = npend_v
        self.next_arrival[rows] = narr_l
        self.g_wait[rows] = w_v + npend_v
        self.next_fin[rows] = nf_v
        self.usage[rows] = usage_l
        self.gen_dirty[rows[dec_v > 0]] = True
        self.dirty[rows] = True
        self.g_freq[rows] = self.freq[rows]
        self.g_pow[rows] = p_v
        due = nf_v <= it_v
        if due.any():
            # decode finishers whose precomputed iteration just came due;
            # runs after the scatters (it reads iters/clock and rewrites
            # S_ctx/R/D/fin_cnt/usage/next_fin for the nodes it touches)
            for i in rows[due].tolist():
                self._process_finishers(i)
        # gauge tail of run_iteration's metric block (post-finisher state)
        self.g_run[rows] = self.R[rows]
        self.g_usage[rows] = self.usage[rows]
        return steps

    # ------------------------------------------------------------------
    # policies
    # ------------------------------------------------------------------
    def _policy_phase(self, stepped: np.ndarray) -> None:
        """Iteration-mode decisions for every node stepped this round —
        the batched mirror of ``policy.maybe_act(engine)`` after
        ``engine.step()``."""
        if self.stacked is not None:
            due = stepped[self.clock[stepped]
                          >= self.stacked.next_sample[stepped]]
            if len(due):
                self.stacked.act(due, self._snap_matrix(due),
                                 self.clock[due].copy(),
                                 actuate=self._iter_hook)
        else:
            for i in stepped.tolist():
                pol = self.policies[i]
                if pol is not None:
                    pol.maybe_act(self._facades[i])

    def _fire_ticks(self, nev: np.ndarray) -> None:
        """Tick-mode decisions: fire every POLICY_TICK scheduled strictly
        before its node's next event (ticks at exactly the event time
        fire after the step — POLICY_TICK yields to node events in the
        event loop's same-time ordering)."""
        while True:
            due = self.tick_alive & (self.next_tick < nev)
            if not due.any():
                break
            idx = np.flatnonzero(due)
            t = self.next_tick[idx].copy()
            if self.stacked is not None:
                self.stacked.act(idx, self._snap_matrix(idx), t,
                                 actuate=self._tick_hook)
            else:
                for j, i in enumerate(idx.tolist()):
                    pol = self.policies[i]
                    tick = getattr(pol, "tick", None)
                    if tick is not None:
                        tick(self._facades[i], float(t[j]))
                    else:
                        pol.maybe_act(self._facades[i])
            self.next_tick[idx] = t + self.tick_period[idx]

    # ------------------------------------------------------------------
    # fleet ticks + power metering (EventLoop semantics)
    # ------------------------------------------------------------------
    def _fleet_energy_j(self) -> float:
        # ordered Python sum over flushed engines — same accumulation
        # order (and hence bits) as EventLoop._fleet_energy_j
        return sum(nd.engine.metrics.c.energy_joules_total
                   for nd in self.nodes)

    def _meter_power(self, t: float) -> None:
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

    def _propagate_bands(self, bands) -> None:
        """EventLoop._propagate_bands against the real nodes (engines are
        flushed whenever this runs)."""
        if not bands:
            return
        for i, band in enumerate(bands):
            if band is None:
                continue
            lo, hi = band
            if lo > hi:
                lo, hi = hi, lo
            set_band = getattr(self.policies[i], "set_band", None)
            if set_band is not None:
                set_band(lo, hi)
            eng = self.engines[i]
            f = min(max(eng.frequency, lo), hi)
            if f != eng.frequency:
                eng.set_frequency(f)

    def _fire_fleet_tick(self) -> None:
        T = self._T
        for i in range(self.n):
            self._flush(i)
        self.fleet_policy.act(self.engines, T)
        self._propagate_bands(getattr(self.fleet_policy, "bands", None))
        self._meter_power(T)
        for i in range(self.n):
            self._refresh_actuation(i)
        if T > self.now:
            self.now = T
        self._T = T + self._fleet_period

    # ------------------------------------------------------------------
    def run(self) -> int:
        while self.steps < self.max_iters:
            sched_work = (self.R > 0) | (self.W > 0)
            nev = np.where(sched_work, self.clock, self.next_arrival)
            active = np.isfinite(nev)
            if self._tick_mode:
                # drained nodes' tick trains die silently, as the event
                # loop's dying POLICY_TICK pop does
                dead = self.tick_alive & ~active
                if dead.any():
                    self.tick_alive[dead] = False
            if not active.any():
                break
            if self._T is not None:
                eligible = active & (nev < self._T)
                if not eligible.any():
                    self._fire_fleet_tick()
                    continue
            else:
                eligible = active
            if self._tick_mode:
                self._fire_ticks(nev)
                # tick actuation can advance clocks (transition stalls):
                # a pending arrival may now be due — reclassify below
            classB = eligible & (~sched_work | (self.W > 0) | (self.P > 0)
                                 | (self.next_arrival <= self.clock))
            a_idx = np.flatnonzero(eligible & ~classB)
            b_idx = np.flatnonzero(classB)
            fast = self.classb_path == "vector"
            remaining = self.max_iters - self.steps
            if remaining < len(a_idx) + len(b_idx):
                # the budget can't cover one step per eligible node this
                # round: finish in strict event-time order, one step at
                # a time, so the loop lands exactly on max_iters like
                # EventLoop.run
                elig = np.flatnonzero(eligible)
                j = int(elig[int(np.argmin(nev[elig]))])
                jj = np.asarray([j])
                if classB[j]:
                    if fast:
                        self.steps += self._step_classb(jj)
                    else:
                        self._step_py(j)
                        self.steps += 1
                else:
                    self.steps += self._step_trains(jj, 1)
                t_j = float(nev[j])
                if t_j > self.now:
                    self.now = t_j
                if not self._tick_mode:
                    self._policy_phase(jj)
                if self._round_hook is not None:
                    self._round_hook(self)
                continue
            if len(a_idx):
                cap = self.train_cap
                budget_a = remaining - len(b_idx)
                if budget_a < len(a_idx) * cap:
                    cap = budget_a // len(a_idx)   # >= 1 by the branch above
                self.steps += self._step_trains(a_idx, cap)
            if len(b_idx):
                if fast:
                    self.steps += self._step_classb(b_idx)
                else:
                    for i in b_idx.tolist():
                        self._step_py(i)
                    self.steps += len(b_idx)
            t_max = float(np.max(nev[eligible]))
            if t_max > self.now:
                self.now = t_max
            if not self._tick_mode:
                self._policy_phase(np.flatnonzero(eligible))
            if self._round_hook is not None:
                self._round_hook(self)

        drained = not np.isfinite(
            np.where((self.R > 0) | (self.W > 0), self.clock,
                     self.next_arrival)).any()
        for i in range(self.n):
            self._flush(i)
        if self.stacked is not None:
            self.stacked.writeback()
        if self.fleet_policy is not None:
            if drained and self._T is not None and self._T > self.now:
                # the pending FLEET_TICK pops once more (and dies); its
                # pop still advances the loop's virtual now
                self.now = self._T
            self._meter_power(max([self.now]
                                  + [float(x) for x in self.clock]))
        return self.steps
