"""The device trace of a stated slice of the window, and what the
per-layer metrics and the ``breakdown`` read from it.

The slice opens 40% into the window and lasts a fifth of it, at most
``MAX_SLICE_S``, counted from when the profiler has started (set-up starts
and stops it once, so that its own start-up is not in the window).
``torch.profiler`` records the card's kernels (those of
CUDA graph replays one by one) and the harness's spans: ``execute#<i>``
around iteration i's ``TorchBackend.execute``, ``policy`` around the
policy's call, ``step`` around each drive call, ``submit`` around each
submission. The first traced iteration is dropped (the profiler has lost
kernels at a trace's start); the traced window runs from the start of the
second ``execute`` span to the end of the last whole ``step`` span.
Because ``execute`` synchronises the card before and after, each kernel
belongs to the iteration whose ``execute`` span holds its start.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from bench.serve import _nospan

MAX_SLICE_S = 2.0
OPEN_AT = 0.4
SHARE = 0.2
LABELS = ("execute", "policy", "submit")     # innermost first; else
# "schedule" inside a step (the engine's own host work), "harness" outside


@dataclasses.dataclass
class Traced:
    """What the slice read: per traced iteration, its kernels [(name,
    start_us, dur_us)]; the union of kernel time, the window's length, the
    longest-running kernels and the idle time by host span."""
    kernels: Dict[int, List[Tuple[str, float, float]]]
    busy_s: float
    window_s: float
    ops: List[Tuple[str, float]]
    idle: List[Tuple[str, float]]


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


class Tracer:
    def __init__(self):
        self.prof = None
        self.state = "before"
        self.t_open = self.t_close = None
        self.result: Optional[Traced] = None
        # the profiler's first start in a process takes seconds
        warm = _profiler()
        warm.start()
        torch.ones(8, device="cuda").sum().item()
        warm.stop()

    def plan(self, wall0: float, seconds: float) -> None:
        self.t_open = wall0 + OPEN_AT * seconds
        self.length = min(MAX_SLICE_S, SHARE * seconds)

    def tick(self, now: float, loop) -> None:
        if self.state == "before" and now >= self.t_open:
            self.prof = _profiler()
            self.prof.start()
            loop.rec.span = torch.profiler.record_function
            self.state = "tracing"
            self.t_close = time.perf_counter() + self.length
        elif self.state == "tracing" and now >= self.t_close:
            self._stop(loop)

    def finish(self, loop) -> None:
        if self.state == "tracing":
            self._stop(loop)

    def _stop(self, loop) -> None:
        torch.cuda.synchronize()
        loop.rec.span = _nospan
        self.prof.stop()
        self.state = "done"

    def read(self) -> Optional[Traced]:
        """The slice reduced (once the window has closed)."""
        if self.result is None and self.prof is not None:
            self.result = reduce(events_of(self.prof))
            self.prof = None
        return self.result


def events_of(prof):
    """(name, on the card, start us, end us) of every event the profiler
    kept, read from its raw results."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.name(), e.device_type() == _cuda(),
                    start, start + e.duration_ns() / 1e3))
    return out


def _cuda():
    from torch.autograd import DeviceType
    return DeviceType.CUDA


def reduce(events) -> Traced:
    """``events``: (name, on the card, start us, end us)."""
    kernels, spans = [], []
    for name, on_card, a, b in events:
        ours = name.startswith("execute#") or name in ("policy", "step",
                                                       "submit")
        if on_card and not ours:
            kernels.append((name, a, b - a))
        elif ours and not on_card:
            # (the profiler also marks each span on the card's timeline,
            # where it is no kernel)
            spans.append((name, a, b))
    execs = sorted((s for s in spans if s[0].startswith("execute#")),
                   key=lambda s: s[1])
    steps = sorted((s for s in spans if s[0] == "step"), key=lambda s: s[1])
    if len(execs) < 2 or not steps:
        return Traced({}, 0.0, 0.0, [], [])
    w0, w1 = execs[1][1], steps[-1][2]
    kernels.sort(key=lambda k: k[1])
    starts = [k[1] for k in kernels]
    per_iter: Dict[int, list] = {}
    for name, a, b in execs[1:]:
        if b > w1:
            break
        i = int(name.split("#")[1])
        lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        per_iter[i] = kernels[lo:hi]
    inside = [k for k in kernels if w0 <= k[1] and k[1] + k[2] <= w1]
    busy, gaps = _union(inside, w0, w1)
    by_name: Dict[str, float] = {}
    for name, _, d in inside:
        by_name[name] = by_name.get(name, 0.0) + d * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle: Dict[str, float] = {}
    edges = sorted({t for _, a, b in spans for t in (a, b)})
    for a, b in gaps:
        # each part of a gap goes to the innermost span that holds it
        cuts = [a] + edges[bisect.bisect_right(edges, a):
                           bisect.bisect_left(edges, b)] + [b]
        for x, y in zip(cuts, cuts[1:]):
            lab = _label(spans, (x + y) / 2)
            idle[lab] = idle.get(lab, 0.0) + (y - x) * 1e-6
    return Traced(per_iter, busy * 1e-6, (w1 - w0) * 1e-6,
                  [[n[:160], s] for n, s in ops],
                  sorted(([k, v] for k, v in idle.items()),
                         key=lambda kv: -kv[1])[:10])


def _union(kernels, w0: float, w1: float):
    """Busy time (us) of the union of kernel intervals (sorted by start)
    from w0 to w1, and the idle gaps between them."""
    busy, gaps, end = 0.0, [], w0
    for _, a, d in kernels:
        b = a + d
        if a > end:
            gaps.append((end, a))
            busy += d
            end = b
        elif b > end:
            busy += b - end
            end = b
    if end < w1:
        gaps.append((end, w1))
    return busy, gaps


def _label(spans, t: float) -> str:
    hit = {s[0].split("#")[0] for s in spans if s[1] <= t <= s[2]}
    for lab in LABELS:
        if lab in hit:
            return lab
    return "schedule" if "step" in hit else "harness"


def kernel_time(kernels, needle: str) -> float:
    """Seconds of the kernels whose name holds ``needle``."""
    return sum(d for name, _, d in kernels if needle in name) * 1e-6


def busy_time(kernels) -> float:
    """Seconds in which at least one of ``kernels`` ran."""
    if not kernels:
        return 0.0
    ks = sorted(kernels, key=lambda k: k[1])
    busy, _ = _union(ks, ks[0][1], ks[0][1])
    return busy * 1e-6
