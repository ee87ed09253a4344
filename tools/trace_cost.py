"""What the program's span trace costs when it is on: one run of a
benchmark cell as ``python3 bench/run.py ... --trace 0`` makes it, with
the trace forced on for the whole run (``--force 1``) or left to follow
the profiler, which no ``--trace 0`` run starts (``--force 0``). Alternate
the two in one call on one card and compare the end-to-end metrics:

    python3 tools/trace_cost.py --workload <cell> --seed <n> \
        --seconds <s> --force <0|1>

from the root of a checkout. Prints the result line of ``bench/run.py``,
its ``info`` holding ``forced``, the number of spans kept and, with the
trace forced on, what its replays read over the window with no profiler
running, each timed by its graph's own CUDA events: the medians of the
card's time for the decode replay and for the 64-token prefill replay
(ms), and the replays' share of the window's wall time (%).
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run  # noqa: E402


def replays(trace, lengths, iterations: int, window_s: float) -> dict:
    """The window's replays (its last ``iterations`` iterations) as the
    forced trace timed them on the card. ``lengths``: the backend's
    ``prefill_lengths``, one for each prefill replay, all of which a trace
    forced on from the start has recorded."""
    prefills = sorted((s for s in trace.spans
                       if s.name == "backend.replay.prefill"),
                      key=lambda s: s.iteration)
    bucket = {s.iteration: n for s, n in zip(prefills, lengths)}
    first = trace.executes - iterations
    spans = [s for s in trace.spans if s.iteration >= first]
    decode = [s.device_ms for s in spans if s.name == "backend.replay.decode"]
    prefill = [s.device_ms for s in spans
               if s.name == "backend.replay.prefill"
               and bucket[s.iteration] == 64]
    timed = sum(s.device_ms for s in spans
                if s.name.startswith("backend.replay."))
    return {"decode_replay_ms": statistics.median(decode) if decode
            else None,
            "forward_64_ms": statistics.median(prefill) if prefill
            else None,
            "replay_share": 100.0 * 1e-3 * timed / window_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--force", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)
    run.setup_env()
    held = []

    def prepare(backend):
        backend.trace.force = bool(args.force)
        # the trace and the list of forward lengths, which the backend
        # appends to, not the backend, whose memory the run frees
        held.extend((backend.trace, backend.prefill_lengths))

    result = run.run_cell(args.workload, args.seed, args.seconds, False,
                          "cuda", prepare=prepare)
    trace, lengths = held
    result["info"].update(forced=bool(args.force), spans=len(trace.spans))
    if args.force:
        result["info"]["replays"] = replays(
            trace, lengths, result["info"]["iterations"],
            result["info"]["window_s"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
