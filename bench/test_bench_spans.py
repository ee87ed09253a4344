"""The program's span trace under the harness, and the two metrics that
read it: a small cell served under a CPU ``torch.profiler`` gives every
iteration the program's tree of spans under the harness's own index, and
each program ``backend.execute``, mapped onto the profiler's clock, lies
inside the harness's ``execute#i``; ``replay_idle`` and
``tools/trace_check.py`` checked by hand on a planted trace and
spans."""
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bench import run, trace
from bench.cell import load_module, ROOT
from bench.serve import _nospan
from bench.small import small_cell
from repro_torch.serving.spans import Span, SpanTrace

SEED = 2**31 + 303
CELLS = ["deepseek-v2-lite-16b.normal", "mamba2-1.3b.chat"]
PARENT = {"engine.iteration": None, "engine.schedule": "engine.iteration",
          "backend.execute": "engine.iteration",
          "engine.complete": "engine.iteration"}


class _CpuTracer:
    """The harness's tracer on the CPU: the profiler and the harness's
    spans on from the window's first step to its end."""

    def __init__(self):
        self.prof = None
        # the profiler's first start in a process takes seconds
        warm = profile(activities=[ProfilerActivity.CPU])
        warm.start()
        warm.stop()

    def plan(self, wall0, seconds):
        pass

    def tick(self, now, loop):
        if self.prof is None:
            self.prof = profile(activities=[ProfilerActivity.CPU])
            self.prof.start()
            loop.rec.span = record_function

    def finish(self, loop):
        loop.rec.span = _nospan
        self.prof.stop()


@pytest.mark.parametrize("name", CELLS)
def test_a_small_cell_under_a_profiler_gives_every_iteration_its_spans(
        name):
    cell = small_cell(name)
    backend, _ = run.build(cell, SEED, torch.device("cpu"))
    tracer = _CpuTracer()
    loop, _ = run.serve_window(cell, backend, SEED, 1.0, tracer)
    events = trace.events_of(tracer.prof)
    execs = {int(n.split("#")[1]): (a, b) for n, _, a, b in events
             if n.startswith("execute#")}
    tr = loop.engine.trace
    by = tr.by_iteration()
    assert len(execs) > 5 and sorted(by) == sorted(execs)
    for i, spans in by.items():
        names = {s.name: s for s in spans}
        assert len(names) == len(spans)
        for s in spans:
            assert s.parent == PARENT.get(s.name, "backend.execute")
        ex = names["backend.execute"]
        it = loop.rec.iterations[i]
        want = {"backend.wait", "backend.sync"} | set(PARENT)
        if it.bucket:
            want.add("backend.replay.prefill")
        if it.rows:
            want |= {"backend.prepare", "backend.replay.decode"}
        assert set(names) == want
        a, b = execs[i]
        assert a <= tr.epoch_us(ex.start_ns) <= tr.epoch_us(ex.end_ns) <= b
    # the program's spans are none of the profiler's events
    assert not [n for n, *_ in events if n.startswith(("engine.",
                                                       "backend."))]


# -- the readers, by hand -------------------------------------------------

def _span(name, a, b, i, parent=None, ms=None):
    """A planted span from a to b (us on the profiler's clock)."""
    return Span(name, int(a * 1e3), int(b * 1e3), parent, i, ms)


def _iteration(i, it, sched, ex, kids, complete):
    out = [_span("engine.iteration", *it, i),
           _span("engine.schedule", *sched, i, "engine.iteration"),
           _span("backend.execute", *ex, i, "engine.iteration"),
           _span("engine.complete", *complete, i, "engine.iteration")]
    for name, a, b, *ms in kids:
        out.append(_span(name, a, b, i, "backend.execute",
                         ms[0] if ms else None))
    return out


def _ev(name, a, b):
    return (name, a, b - a)


COPY = "Memcpy HtoD (Pinned -> Device)"
# iteration 1 mixed, 2 with no replay, 3 decode-only
SPANS = {
    1: _iteration(1, (90, 160), (90, 95), (96, 150),
                  [("backend.wait", 96, 99),
                   ("backend.replay.prefill", 99, 101, 0.0205),
                   ("backend.prepare", 101, 102),
                   ("backend.replay.decode", 102, 104, 0.016),
                   ("backend.sync", 104, 150)], (151, 160)),
    2: _iteration(2, (165, 200), (165, 170), (171, 190),
                  [("backend.wait", 171, 173), ("backend.sync", 173, 190)],
                  (191, 200)),
    3: _iteration(3, (205, 290), (205, 210), (211, 280),
                  [("backend.wait", 211, 213), ("backend.prepare", 213, 215),
                   ("backend.replay.decode", 215, 217, 0.05),
                   ("backend.sync", 217, 280)], (281, 290)),
}
# each iteration's events as the profiler's clock placed them: the tail
# of an earlier replay (Z), then 30 us of the host; the prefill (A, B),
# the copy, the decode (C, D); a replay's tail in the iteration that ran
# none (H, I); the copy, then a decode (E, F, G) with a gap of 20 us
KERNELS = {
    1: [_ev("Z", 60, 70), _ev("A", 100, 110), _ev("B", 112, 120),
        _ev(COPY, 121, 122), _ev("C", 125, 130), _ev("D", 131, 140)],
    2: [_ev("H", 180, 185), _ev("I", 186, 190)],
    3: [_ev(COPY, 214, 216), _ev("E", 230, 240), _ev("F", 242, 250),
        _ev("G", 270, 275)],
}


def _run(iterations, busy_us):
    st = SpanTrace()
    st.clock = (0, 0)
    st.spans = [s for i in iterations for s in SPANS[i]]
    traced = trace.Traced({i: KERNELS[i] for i in iterations},
                          busy_us * 1e-6, 200e-6, [], [])
    return types.SimpleNamespace(
        traced=traced, loop=types.SimpleNamespace(
            engine=types.SimpleNamespace(trace=st)))


def _reader(name):
    return load_module(ROOT / "bench" / "metrics" / f"{name}.py", "metric")


def _split(err):
    (line,) = [x for x in err.splitlines() if x.startswith("replay_idle:")]
    parts = line.split("by program span: ")[1].split(")")[0]
    return line, {k: float(v) for k, v in
                  (p.rsplit(" ", 1) for p in parts.split(", "))}


def test_replay_idle_by_hand(capsys):
    # busy: Z 10, A 10, B 8, the copies 1 + 2, C 5, D 9, H 5, I 4, E 10,
    # F 8, G 5
    got = _reader("replay_idle").read(_run([1, 2, 3], 77))
    # the host's shortest turnaround: iteration 2's execute ends at 190,
    # iteration 3's first launch starts at 215, so runs are cut at gaps of
    # 25 us: Z | A B (2 idle) | C D (1) ; H I (1) ; E F G (2 + 20); the
    # 40 us from D to H lies between two iterations' events, in none
    assert got == pytest.approx(100 * 26 / 200)
    line, host = _split(capsys.readouterr().err)
    assert "idle in replays 0.000026 s (cut at gaps of 25.0 us), between " \
        "replays 0.000097 s" in line
    # iteration 3's turnaround, 190-215 (iteration 1 has no iteration 0
    # before it), and the 72 us left, in the launches
    want = {"engine.iteration": 1 + 1, "engine.complete": 9, "outside": 5,
            "engine.schedule": 5, "backend.wait": 2, "backend.prepare": 2}
    assert host == pytest.approx({k: v * 1e-6 for k, v in want.items()},
                                 abs=1e-9)
    assert "of 1 iterations 0.000025 s" in line
    assert "in the launches, 0.000072 s" in line


def test_replay_idle_reads_a_slice_with_no_prefill():
    # E F G (2 + 20) and H I (1) of 200 us
    got = _reader("replay_idle").read(_run([2, 3], 34))
    assert got == pytest.approx(100 * 23 / 200)


def test_replay_idle_reads_nothing_from_a_program_without_spans():
    run_ = _run([1, 2, 3], 77)
    run_.loop.engine = types.SimpleNamespace()
    assert _reader("replay_idle").read(run_) is None
    run_ = _run([1, 2, 3], 77)
    run_.traced = None
    assert _reader("replay_idle").read(run_) is None


def test_trace_check_by_hand():
    """``tools/trace_check.py`` on the planted trace, with the profiler's
    own marks of ``execute#1`` and ``execute#3`` on the card and the
    harness's spans on the host: each replay's events against its
    kernels' extent, the slack, the marks' drift and the idle inside the
    replays."""
    tc = load_module(ROOT / "tools" / "trace_check.py", "trace_check")
    run_ = _run([1, 2, 3], 77)
    events = [("execute#1", False, 95, 152), ("execute#3", False, 210, 282),
              ("execute#1", True, 100, 140), ("execute#3", True, 214, 275)]
    events += [(n, True, a, a + d) for i in (1, 2, 3)
               for n, a, d in KERNELS[i]]
    out = tc.check(events, run_.loop.engine.trace, run_.traced, 25.0,
                   [0, 64, 0, 0])
    assert out["iterations"] == 2
    assert out["prefill"]["extent_ms_at_64"] == [0.02] * 3
    # prefill A-B 20 us against 20.5; decode C-D 15 against 16, E-G 45
    # against 50: all within 20 us
    assert out["prefill"]["replays"] == 1
    assert out["prefill"]["extent_minus_events_rel"][1] == pytest.approx(
        -0.5 / 20.5)
    assert out["decode"]["extent_minus_events_rel"] == pytest.approx(
        [-0.1, (-0.1 - 1 / 16) / 2, -1 / 16])
    assert out["prefill"]["outside_2pct_or_20us"] == 0
    assert out["decode"]["outside_2pct_or_20us"] == 0
    # placed by the clock, Z (60-70) lies 36 us before execute 1's start
    assert out["slack_us_clock_placed"] == [-36, -16.5, 3]
    assert out["slack_us_mark_placed"] == [4, 5, 10]
    assert out["mark_minus_host_execute_us"] == [5, 4]
    assert out["harness_minus_program_execute_us"] == [-1, -1, -1]
    # gaps inside the replays: 2, 1, then 2 + 20 = 25 us of 200
    assert out["in_replay_idle_pct_marks"] == pytest.approx(12.5)
    assert out["widest_gap_in_a_replay_us"] == 20
    # a replay whose events read 30 us off its kernels is counted
    spans = run_.loop.engine.trace.spans
    k = next(j for j, s in enumerate(spans)
             if s.name == "backend.replay.decode" and s.iteration == 3)
    spans[k] = spans[k]._replace(device_ms=0.075)
    out = tc.check(events, run_.loop.engine.trace, run_.traced, 25.0)
    assert out["decode"]["outside_2pct_or_20us"] == 1
    assert out["decode"]["worst_outside"] == (3, -30, 75)
