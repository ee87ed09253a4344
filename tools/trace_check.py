"""What a traced run of a benchmark cell shows of the program's spans
against the device trace: one run as ``python3 bench/run.py ... --trace 1``
makes it, with the profiler's raw events kept, then

- each graph replay's time on the card as its span reads it
  (``device_ms``, the graph's own CUDA events) against its kernels' extent
  on the device trace; a replay's kernels are the card's events inside the
  profiler's own mark of ``execute#i`` on the card's timeline (placed by
  the launches, not by the clock), cut at the copy of ``pos``: the
  prefill forward before it, the decode step after (and the forwards'
  extent at the 64-token bucket, by the harness's record of each
  iteration);
- the slack of each iteration's kernels inside its ``backend.execute``
  span mapped onto the profiler's clock, for the kernels the harness gives
  the iteration (``run.traced.kernels[i]``, placed by the clock) and for
  those of its card mark; and how far the card mark's start lies from the
  harness's ``execute#i`` on the host, first to last iteration (the card's
  timestamps drift against the host's);
- the card's idle inside the replays, from the card marks, against the
  ``replay_idle`` metric, and the widest gap inside a replay against the
  cut at which that metric splits the card's events into replays;
- how long the host spends in each replay span (launching the graph).

    python3 tools/trace_check.py --workload <cell> --seed <n> \\
        --seconds <s>

from the root of a checkout, on the card. Prints the result line of
``bench/run.py``, then one line ``trace_check: {...}`` (JSON).
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

for _p in ("src", ""):
    _p = str(Path(__file__).resolve().parents[1] / _p)
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import run, trace  # noqa: E402
from bench.cell import ROOT, load_module  # noqa: E402

COPY = "Memcpy HtoD"
OURS = ("execute#", "policy", "step", "submit")


def _q(xs):
    """min, median, max (None where empty)."""
    return ([min(xs), statistics.median(xs), max(xs)] if xs
            else [None, None, None])


def card_replays(events, by):
    """{i: [(span, [kernel events])]} from the card marks of ``execute#i``:
    the events inside each mark, cut at the first copy of ``pos``."""
    card = sorted((e for e in events if e[1]), key=lambda e: e[2])
    marks = {int(e[0].split("#")[1]): e for e in card
             if e[0].startswith("execute#")}
    rest = [e for e in card if not e[0].startswith(OURS)]
    out = {}
    for i, m in marks.items():
        reps = sorted((s for s in by.get(i, ())
                       if s.name.startswith("backend.replay.")),
                      key=lambda s: s.start_ns)
        inside = [e for e in rest if m[2] <= e[2] <= m[3]]
        cut = next((k for k, e in enumerate(inside)
                    if e[0].startswith(COPY)), None)
        pre = inside if cut is None else inside[:cut]
        post = [] if cut is None else [e for e in inside[cut + 1:]
                                       if not e[0].startswith(COPY)]
        runs = []
        for s in reps:
            ks = pre if s.name.endswith(".prefill") else post
            if ks:
                runs.append((s, ks))
        out[i] = runs
    return out, marks


def _gaps(ks):
    """(idle inside the run, its widest gap), us."""
    idle, widest, end = 0.0, 0.0, ks[0][3]
    for e in ks[1:]:
        if e[2] > end:
            idle += e[2] - end
            widest = max(widest, e[2] - end)
        end = max(end, e[3])
    return idle, widest


def check(events, st, traced, cut, buckets=()) -> dict:
    """The checks above, from the profiler's raw ``events``, the program's
    span trace ``st``, the reduced slice ``traced``, ``replay_idle``'s cut
    (us) and the harness's prefill bucket of each iteration (``buckets``,
    by index)."""
    by = st.by_iteration()
    reps, marks = card_replays(events, by)
    host = {int(e[0].split("#")[1]): e for e in events
            if not e[1] and e[0].startswith("execute#")}
    its = sorted(set(traced.kernels) & set(marks))
    # (i, extent - events, events, host's launch, extent), us but the
    # launch (ms)
    rows = {"prefill": [], "decode": []}
    inside_us, widest = 0.0, 0.0
    for i in its:
        for s, ks in reps[i]:
            dev = s.device_ms * 1e3
            ext = max(e[3] for e in ks) - ks[0][2]
            rows[s.name.rsplit(".", 1)[1]].append(
                (i, ext - dev, dev, (s.end_ns - s.start_ns) / 1e6, ext))
            idle, w = _gaps(ks)
            inside_us += idle
            widest = max(widest, w)
    out = {"iterations": len(its)}
    for kind, rs in rows.items():
        off = [r for r in rs if abs(r[1]) > max(0.02 * r[2], 20.0)]
        out[kind] = {
            "replays": len(rs),
            "extent_minus_events_rel": _q([r[1] / r[2] for r in rs]),
            "outside_2pct_or_20us": len(off),
            "worst_outside": max(off, key=lambda r: abs(r[1]))[:3]
            if off else None,
            "device_ms": _q([r[2] / 1e3 for r in rs]),
            "extent_ms": _q([r[4] / 1e3 for r in rs]),
            "extent_ms_at_64": _q([r[4] / 1e3 for r in rs
                                   if r[0] < len(buckets)
                                   and buckets[r[0]] == 64]),
            "host_launch_ms": _q([r[3] for r in rs])}

    def slack(i, ks):
        (ex,) = [s for s in by[i] if s.name == "backend.execute"]
        a, b = st.epoch_us(ex.start_ns), st.epoch_us(ex.end_ns)
        return min(min(k[1] - a, b - (k[1] + k[2])) for k in ks)
    by_clock = [slack(i, traced.kernels[i]) for i in its
                if traced.kernels[i]]
    by_mark = [slack(i, [(e[0], e[2], e[3] - e[2]) for e in ks])
               for i in its for _, ks in reps[i]]
    drift = [marks[i][2] - host[i][2] for i in its if i in host]
    ex_host = [host[i][2] - st.epoch_us(s.start_ns) for i in its
               if i in host for s in by[i] if s.name == "backend.execute"]
    window_us = traced.window_s * 1e6
    out.update(
        slack_us_clock_placed=_q(by_clock),
        slack_us_mark_placed=_q(by_mark),
        mark_minus_host_execute_us=[drift[0], drift[-1]] if drift else None,
        harness_minus_program_execute_us=_q(ex_host),
        in_replay_idle_pct_marks=100.0 * inside_us / window_us
        if window_us else None,
        widest_gap_in_a_replay_us=widest,
        replay_idle_cut_us=cut)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.setup_env()
    kept, held = {}, []
    reduce, serve_window = trace.reduce, run.serve_window

    def keep(events):
        kept["events"] = events
        kept["traced"] = reduce(events)
        return kept["traced"]

    def keep_loop(*a, **k):
        kept["loop"], setup_s = serve_window(*a, **k)
        return kept["loop"], setup_s
    trace.reduce, run.serve_window = keep, keep_loop
    result = run.run_cell(args.workload, args.seed, args.seconds, True,
                          "cuda", prepare=lambda b: held.append(b.trace))
    print(json.dumps(result), flush=True)
    st = held[0]
    ri = load_module(ROOT / "bench" / "metrics" / "replay_idle.py", "ri")
    turns = ri._turnarounds(st.by_iteration())
    cut = min((b - a) / 1e3 for a, b in turns.values()) if turns else None
    out = check(kept["events"], st, kept["traced"], cut,
                [it.bucket for it in kept["loop"].rec.iterations])
    out["replay_idle"] = result["metrics"].get("replay_idle",
                                               {}).get("value")
    print("trace_check: " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
