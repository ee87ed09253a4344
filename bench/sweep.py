"""The sweep that fixes an open-loop mix's rate, on the card:

    python3 bench/sweep.py --workload <cell> --rates 8,12,16 --seed <n> \\
        --seconds <s>

In one process, for each mean rate (requests/s on the engine's clock), a
run of the cell's traffic at that rate for ``--seconds``, reporting the
queue at the window's end (requests arrived and not yet scheduled), the
requests finished and the tails. The highest rate whose queue does not
grow through the window is the sustained rate; the mix's ``rate_per_s``
is set from it once, by hand.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run as R  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    R.setup_env()
    import torch

    from bench.cell import load_cell
    cell = load_cell(args.workload)
    backend, _ = R.build(cell, args.seed, torch.device("cuda"))
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic["rate_per_s"] = rate
        loop, _ = R.serve_window(cell, backend, args.seed, args.seconds)
        eng = loop.engine
        half = loop.clock0 + (loop.clock1 - loop.clock0) / 2
        queued = [len(eng.sched.waiting) + sum(
            1 for p in eng._pending if p[0] <= loop.clock1)]
        e2e = R.end_to_end(loop, 0.0)
        print(json.dumps({
            "rate_per_s": rate, "queue_at_end": queued[0],
            "arrived": len(loop.window_requests()),
            "finished": sum(1 for r in eng.finished
                            if loop.clock0 < r.finish_time <= loop.clock1),
            "unscheduled_from_first_half": sum(
                1 for r in loop.window_requests()
                if r.arrival_time <= half and r.first_scheduled_time is None),
            "engine_s": loop.clock1 - loop.clock0,
            "ttft_p95": e2e["ttft_p95"], "itl_p95": e2e["itl_p95"],
            "energy_per_token": e2e["energy_per_token"],
            "output_tokens_per_s": e2e["output_tokens_per_s"]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
