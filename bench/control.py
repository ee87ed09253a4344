"""The readings that the limits of ``correct`` are set from, on the card:

    python3 bench/control.py --workload <cell> --seeds 11,12,... \\
        --control 3 --seconds <s>

In one process (the backend built once, its weights drawn again in place
for each seed): for every seed, a run of the cell's traffic for
``--seconds`` (warm-up, window) and the numbers that ``check.py`` compares
(the lower readings: the largest over the seeds); for the first
``--control`` seeds also the control, the fp8 reference put in the
program's place over the same inputs (the upper readings: the smallest).
One JSON line per seed, then one with both readings.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run as R  # noqa: E402


def readings(name: str, seeds, n_control: int, seconds: float,
             device: str = "cuda", cell=None):
    import torch

    from bench import check
    from bench.cell import load_cell

    cell = cell or load_cell(name)
    dev = torch.device(device)
    backend, params = R.build(cell, seeds[0], dev)
    rows = []
    for k, seed in enumerate(seeds):
        gen = torch.Generator(device=dev).manual_seed(seed % 2**63)
        cell.model.make_weights(cell.config, gen, dev, into=params)
        loop, _ = R.serve_window(cell, backend, seed, seconds)
        pos, logits, prefill = R.outputs(loop, backend)
        layers = list(cell.model.program_cache_layers(backend.cache))
        prog = check.model_numbers(cell.model, cell.config, params, pos,
                                   layers, logits, prefill)
        prog["tokens_miscounted"] = R.tokens_miscounted(loop)
        row = {"seed": seed, "decode_steps": int(pos.shape[0]),
               "buckets": sorted(prefill), "program": prog}
        if k < n_control:
            t0 = time.perf_counter()
            ctl = check.control_outputs(cell.model, cell.config, params,
                                        pos, sorted(prefill), layers)
            row["control"] = check.model_numbers(cell.model, cell.config,
                                                 params, pos, *ctl,
                                                 teacher=layers)
            row["control_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    lower = {k: max((r["program"][k] for r in rows
                     if r["program"][k] is not None), default=None)
             for k in check.NUMBERS}
    upper = {k: min((r["control"][k] for r in rows if "control" in r
                     and r["control"].get(k) is not None), default=None)
             for k in check.NUMBERS[:-1]}
    return {"workload": name, "lower": lower, "upper": upper}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    R.setup_env()
    seeds = [int(s) for s in args.seeds.split(",")]
    print(json.dumps(readings(args.workload, seeds, args.control,
                              args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
