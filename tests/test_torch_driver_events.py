"""Discrete-event driver tests: equivalence with the PR-1 heap-of-clocks
loop (same finished set, clocks, and energy on fixed-seed traces), event
bookkeeping, idle/blocked energy accounting, and the never-backwards
time-monotonicity property (hypothesis-based, skipped without it)."""
import heapq

import pytest

from repro_torch.configs import get_config
from repro_torch.core import AGFTTuner
from repro_torch.energy import A6000
from repro_torch.policies import get_policy
from repro_torch.serving import (EngineConfig, EngineNode, EventKind, EventLoop,
                           InferenceEngine, Request, drive)
from repro_torch.workloads import PROTOTYPES, generate_requests

CFG = get_config("llama3-3b")


def make_engine(**kw):
    return InferenceEngine(CFG, EngineConfig(**kw),
                           initial_frequency=A6000.f_max)


def trace(n=80, rate=3.0, seed=21, workload="normal"):
    return generate_requests(PROTOTYPES[workload], n, base_rate=rate,
                             seed=seed)


def pr1_drive(nodes, *, t_end=None, max_iters=10_000_000):
    """The PR-1 drive loop, verbatim: heap keyed by engine CLOCK, step the
    laggard, then its policy — the reference the event loop must match
    decision-for-decision."""
    heap = []
    for i, node in enumerate(nodes):
        if node.engine.has_work:
            heapq.heappush(heap, (node.engine.clock, i))
    it = 0
    while heap and it < max_iters:
        _, i = heapq.heappop(heap)
        node = nodes[i]
        eng = node.engine
        if not eng.has_work or (t_end is not None and eng.clock >= t_end):
            continue
        eng.step()
        if node.policy is not None:
            node.policy.maybe_act(eng)
        it += 1
        heapq.heappush(heap, (eng.clock, i))
    return it


def engine_state(eng):
    # request_ids come from a process-global counter, so two identical
    # traces get different absolute ids — normalize to the trace-relative
    # id before comparing finished SETS across runs
    ids = [r.request_id for r in eng.finished]
    base = min(ids) if ids else 0
    return {
        "finished_ids": sorted(i - base for i in ids),
        "finish_times": sorted(r.finish_time for r in eng.finished),
        "clock": eng.clock,
        "energy": eng.metrics.c.energy_joules_total,
        "iterations": eng.metrics.c.iterations_total,
    }


# ---------------------------------------------------------------------------
# Equivalence vs the PR-1 loop
# ---------------------------------------------------------------------------

class TestPR1Equivalence:
    def test_single_node_no_policy(self):
        e1, e2 = make_engine(), make_engine()
        e1.submit(trace(120, seed=5))
        e2.submit(trace(120, seed=5))
        s1 = pr1_drive([EngineNode(e1, None)])
        s2 = drive([EngineNode(e2, None)])
        assert s1 == s2
        assert engine_state(e1) == engine_state(e2)

    def test_single_node_agft_decisions(self):
        e1, t1 = make_engine(), AGFTTuner(A6000)
        e1.submit(trace(150, seed=7))
        pr1_drive([EngineNode(e1, t1)])
        e2, t2 = make_engine(), AGFTTuner(A6000)
        e2.submit(trace(150, seed=7))
        drive([EngineNode(e2, t2)])
        assert engine_state(e1) == engine_state(e2)
        h1 = [(h["t"], h["freq"], h["phase"]) for h in t1.history]
        h2 = [(h["t"], h["freq"], h["phase"]) for h in t2.history]
        assert h1 == h2

    def test_multi_node_heterogeneous_policies(self):
        def fleet():
            nodes = []
            for i, pol in enumerate(("agft", "slo", None)):
                eng = make_engine()
                eng.submit(trace(60, seed=30 + i))
                p = get_policy(pol, hardware=A6000) if pol else None
                nodes.append(EngineNode(eng, p))
            return nodes
        n1, n2 = fleet(), fleet()
        pr1_drive(n1)
        drive(n2)
        for a, b in zip(n1, n2):
            assert engine_state(a.engine) == engine_state(b.engine)

    def test_run_until_series(self):
        """The fig11 pattern: repeated run_until on a 30 s cadence must
        land on the same clocks/energies as the PR-1 loop."""
        def series(loop):
            eng = make_engine()
            eng.submit(trace(150, rate=1.0, seed=9))
            t1 = AGFTTuner(A6000)
            out = []
            next_t = 30.0
            while eng.has_work:
                loop([EngineNode(eng, t1)], t_end=next_t)
                out.append((eng.clock,
                            eng.metrics.c.energy_joules_total))
                next_t = eng.clock + 30.0
            return out
        assert series(pr1_drive) == series(drive)


# ---------------------------------------------------------------------------
# Event-loop bookkeeping
# ---------------------------------------------------------------------------

class TestEventLoop:
    def test_event_kinds_counted(self):
        eng = make_engine()
        eng.submit(trace(40, rate=0.5, seed=3))   # sparse -> idle gaps
        loop = EventLoop([EngineNode(eng, None)])
        steps = loop.run()
        assert steps == loop.counts[EventKind.ARRIVAL] \
            + loop.counts[EventKind.ITERATION]
        assert loop.counts[EventKind.ARRIVAL] > 0      # idle-skips happened
        assert loop.counts[EventKind.ITERATION] > 0
        assert loop.counts[EventKind.FLEET_TICK] == 0  # no fleet policy

    def test_virtual_time_monotone_and_final(self):
        eng = make_engine()
        eng.submit(trace(50, seed=4))
        loop = EventLoop([EngineNode(eng, None)])
        loop.run()
        assert loop.now > 0.0
        assert not eng.has_work

    def test_max_iters_respected(self):
        eng = make_engine()
        eng.submit(trace(100, seed=6))
        steps = drive([EngineNode(eng, None)], max_iters=10)
        assert steps == 10
        assert eng.has_work

    def test_blocked_tick_bills_idle_energy(self):
        """A KV-starved engine burns idle power while blocked — time is
        never free (satellite fix: the old blocked tick advanced the clock
        without billing)."""
        eng = make_engine(num_kv_blocks=4, kv_block_size=16,
                          enable_prefix_cache=False)
        # needs 8 blocks; can never allocate, nothing to preempt
        eng.submit([Request(arrival_time=0.0, prompt_len=100,
                            output_len=28)])
        e0 = eng.metrics.c.energy_joules_total
        for _ in range(5):
            eng.step()
        billed = eng.metrics.c.energy_joules_total - e0
        assert billed == pytest.approx(5 * 1e-3 * A6000.p_idle)
        assert eng.clock == pytest.approx(5e-3)

    def test_submit_is_heap_ordered_not_sorted(self):
        """Out-of-order and incremental submits ingest in arrival order."""
        eng = make_engine()
        reqs = trace(30, seed=11)
        for r in reversed(reqs):          # worst-case submit order
            eng.submit([r])
        eng.drain()
        assert len(eng.finished) == 30
        order = [r.arrival_time for r in
                 sorted(eng.finished, key=lambda r: r.first_scheduled_time)]
        assert order == sorted(order)
