"""An in-memory trace of the serving path: spans of each engine iteration
and of the backend's work inside it, each CUDA graph replay timed on the
card.

``TorchBackend`` owns one ``SpanTrace`` (``backend.trace``), and
``InferenceEngine`` reaches it through its backend; an engine whose
backend has none (``SimBackend``) holds ``trace`` None and pays one check
an iteration. The trace records an iteration only while a
``torch.profiler`` records (read once, at the iteration's start) or while
``force`` is set. Otherwise it records nothing and allocates nothing.

The spans of one iteration share its index: the number of
``TorchBackend.execute`` calls before it (``executes``), which is the
``i`` of a caller's own ``execute#i`` count when both start from the
backend's first call. The tree of one iteration, with what each covers:

    engine.iteration              the whole of ``run_iteration``
      engine.schedule             the scheduler's plan, and its retry
                                  after a preemption
      backend.execute             ``TorchBackend.execute``
        backend.wait              the leading synchronisation
        backend.replay.prefill    launching the prefill bucket's graph
        backend.prepare           ``pos`` written to the pinned buffer and
                                  copied to the card
        backend.replay.decode     launching the decode graph
        backend.sync              the trailing synchronisation, up to the
                                  return
      engine.complete             the scheduler's completion and the
                                  counters

A blocked iteration (nothing scheduled, a tick at idle power) runs no
``execute`` and records no span. On the card each replay span also
carries ``device_ms``, the card's time between the two CUDA events that
the replayed graph records itself before its first operation and after
its last (``StepGraph.device_ms``), read after the synchronisation that
ends ``execute`` (no synchronisation of the trace's own); under a
profiler it also holds the card's wait for the profiled launch, so a
replay's own time is read with the trace forced on and no profiler.

Stamps are ``time.perf_counter_ns()``. When recording turns on, the trace
reads one pair (``perf_counter_ns``, ``time_ns``) into ``clock``;
``epoch_us`` maps a stamp through it onto the epoch microseconds of
``torch.profiler``'s events, so that a gap on the card's timeline can be
put down to what the host was doing. The spans are not
``torch.profiler.record_function`` ranges: the profiler marks each such
range on the card's timeline too, where it would be read as a kernel.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch.autograd.profiler as _autograd_profiler


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]         # the parent's name in the same iteration
    iteration: int
    device_ms: Optional[float] = None


class SpanTrace:
    """The spans of the iterations recorded so far (``spans``, each
    iteration's appended as they close)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.force = False
        self.on = False
        self.executes = 0
        self.clock: Optional[Tuple[int, int]] = None
        # this execute's spans so far: (name, start, end, replayed graph)
        self._children: List[Tuple[str, int, int, object]] = []

    def begin(self) -> bool:
        """Whether this iteration is recorded: read once, at its start."""
        on = self.force or _autograd_profiler._is_profiler_enabled
        if on and not self.on:
            self.clock = (time.perf_counter_ns(), time.time_ns())
        self.on = on
        return on

    def child(self, name: str, start_ns: int, graph=None) -> None:
        """A span of ``backend.execute`` from ``start_ns`` to now;
        ``graph``: the ``StepGraph`` it replayed."""
        self._children.append((name, start_ns, time.perf_counter_ns(),
                               graph))

    def replay(self, name: str, graph):
        """``graph()`` as the replay span ``name``; returns what ``graph``
        returns."""
        start = time.perf_counter_ns()
        out = graph()
        self.child(name, start, graph)
        return out

    def end_execute(self, start_ns: int, sync_ns: int) -> None:
        """Close ``backend.execute`` (from ``start_ns``) and its trailing
        ``backend.sync`` (from ``sync_ns``), once the card has
        synchronised; read the replays' times on the card."""
        end = time.perf_counter_ns()
        i = self.executes
        self.spans.append(Span("backend.execute", start_ns, end,
                               "engine.iteration", i))
        for name, a, b, graph in self._children:
            ms = graph.device_ms() if graph is not None else None
            self.spans.append(Span(name, a, b, "backend.execute", i, ms))
        self.spans.append(Span("backend.sync", sync_ns, end,
                               "backend.execute", i))
        self._children.clear()

    def end_iteration(self, start_ns: int, scheduled_ns: int,
                      executed_ns: int) -> None:
        """Close the engine's spans of the iteration whose ``execute`` has
        just returned: scheduled from ``start_ns`` to ``scheduled_ns``,
        completed from ``executed_ns`` to now."""
        end = time.perf_counter_ns()
        i = self.executes - 1
        self.spans.append(Span("engine.iteration", start_ns, end, None, i))
        self.spans.append(Span("engine.schedule", start_ns, scheduled_ns,
                               "engine.iteration", i))
        self.spans.append(Span("engine.complete", executed_ns, end,
                               "engine.iteration", i))

    # -- reading -------------------------------------------------------
    def epoch_us(self, t_ns: int) -> float:
        """A stamp on the profiler's clock (epoch microseconds)."""
        perf, epoch = self.clock
        return (t_ns - perf + epoch) / 1e3

    def by_iteration(self) -> Dict[int, List[Span]]:
        out: Dict[int, List[Span]] = {}
        for s in self.spans:
            out.setdefault(s.iteration, []).append(s)
        return out
