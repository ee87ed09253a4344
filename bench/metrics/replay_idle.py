"""The card's idle time inside the program's graph replays, over the
traced window (%): the gaps between the kernels of one replay, which run
back to back on the one stream, the card's own.

The reader takes each traced iteration's events on the card
(``run.traced.kernels[i]``) in their order there and cuts them into
replays at each copy of ``pos`` to the card (``COPY``, which the
backend's ``backend.prepare`` puts before each decode replay) and at each
gap of at least the host's shortest turnaround: the least time, over the
iterations the program's spans hold, from one iteration's trailing
synchronisation to the next one's first launch, on the host's clock. The
card waited at least that long between any two iterations, and no gap
inside a replay reaches it. The idle inside the replays is what the gaps
within the cut runs add up to.

Only the events are read on the profiler's clock. On the H100 the
profiler's timestamps of the card drift against those of the host by
milliseconds within a slice, so an iteration's events, placed by the
host's spans, may hold the tail of one replay and the head of the next,
and the events that fall between two iterations' spans are in none:
each iteration's events are cut apart, never joined across.

The card's other idle time in the window, between replays, waited on the
host: through its turnaround from one iteration's trailing
synchronisation to the start of the next one's first launch, and then
through part of the launch, until the replay's first kernel starts. The
reader prints on standard error, in one line, the window's idle in and
between replays, the turnarounds over the traced iterations, split by the
innermost program span the host was in (on the host's clock), and the
rest of the idle between replays, which waited on the launches. None
where the program keeps no spans."""
import sys

from bench.trace import _union

COPY = "Memcpy HtoD"
DEPTH = {None: 0, "engine.iteration": 1, "backend.execute": 2}


def _turnarounds(by):
    """{i: (the trailing synchronisation's end in iteration i - 1, the
    start of the first launch in i)} (ns)."""
    out = {}
    for i, spans in by.items():
        reps = [s.start_ns for s in spans
                if s.name.startswith("backend.replay.")]
        prev = [s for s in by.get(i - 1, ()) if s.name == "backend.execute"]
        if reps and prev:
            out[i] = (prev[0].end_ns, min(reps))
    return out


def _runs(events, cut: float):
    """``events`` (sorted by start) less the copies, cut at the copies and
    at gaps of ``cut`` us or more."""
    out, run, end = [], [], None
    for k in events:
        if k[0].startswith(COPY) or (end is not None
                                     and k[1] - end >= cut):
            if run:
                out.append(run)
            run, end = [], None
        if not k[0].startswith(COPY):
            run.append(k)
            end = k[1] + k[2] if end is None else max(end, k[1] + k[2])
    if run:
        out.append(run)
    return out


def read(run):
    tr = run.traced
    trace = getattr(run.loop.engine, "trace", None)
    if tr is None or trace is None or not trace.spans \
            or tr.window_s <= 0 or not tr.kernels:
        return None
    by = trace.by_iteration()
    turns = _turnarounds(by)
    cut = min((b - a) / 1e3 for a, b in turns.values()) if turns \
        else float("inf")
    inside = 0.0                     # us
    for events in tr.kernels.values():
        for r in _runs(sorted(events, key=lambda k: k[1]), cut):
            a = r[0][1]
            b = max(k[1] + k[2] for k in r)
            inside += (b - a) - _union(r, a, b)[0]
    host = {}
    traced = sorted(set(turns) & set(tr.kernels))
    for i in traced:
        for lab, s in _split(by[i - 1] + by[i], *turns[i]).items():
            host[lab] = host.get(lab, 0.0) + s
    between = tr.window_s - tr.busy_s - inside * 1e-6
    turned = sum(host.values())
    parts = ", ".join(f"{k} {v:.6f}" for k, v in
                      sorted(host.items(), key=lambda kv: -kv[1]))
    print(f"replay_idle: window {tr.window_s:.6f} s on the device trace: "
          f"idle in replays {inside * 1e-6:.6f} s (cut at gaps of "
          f"{cut:.1f} us), between replays {between:.6f} s; of that, the "
          f"host's turnarounds before the first launch of {len(traced)} "
          f"iterations {turned:.6f} s (host clock, by program span: "
          f"{parts}) and the rest, in the launches, {between - turned:.6f} "
          f"s", file=sys.stderr, flush=True)
    return 100.0 * inside * 1e-6 / tr.window_s


def _split(spans, a: int, b: int) -> dict:
    """[a, b] (ns) by the innermost of ``spans`` that holds each part
    ("outside" where none does), in seconds."""
    edges = sorted({t for s in spans for t in (s.start_ns, s.end_ns)
                    if a < t < b})
    out: dict = {}
    for x, y in zip([a] + edges, edges + [b]):
        m = (x + y) / 2
        hit = [s for s in spans if s.start_ns <= m <= s.end_ns]
        lab = max(hit, key=lambda s: DEPTH[s.parent]).name if hit \
            else "outside"
        out[lab] = out.get(lab, 0.0) + (y - x) * 1e-9
    return out
