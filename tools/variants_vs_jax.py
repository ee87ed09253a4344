#!/usr/bin/env python3
"""Hold the port's costs of the JAX package's §Perf variants to the JAX
package's, row by row.

    PYTHONPATH=src python3 tools/variants_vs_jax.py \\
        [--golden tests/golden_variants_jax.json] [--only VARIANT,...]

For each row of the golden (``tools/variants_golden.py``: the JAX
package's ``cost_extrapolated`` of an (arch, shape, variant) on the 16x16
mesh) this runs the port's ``repro_torch.launch.dryrun.cost_extrapolated``
with the row's config fields (``replace``) and donation, on meta tensors
over a ``fake`` group of 256 ranks, and prints a markdown table: F, one
rank's FLOPs over the JAX package's; C, the same of the collective bytes;
T, ``u2_temp_bytes`` over the JAX package's; and E, the port's FLOPs a
rank x 256 over its own ``flops_global`` (1: an even split), then the
port's own counts. A ratio over its bound (F ``JAX_FLOPS_BOUND``, C 2, T
``JAX_TEMP_BOUND``; E ``JAX_FLOPS_BOUND`` on the rows with the
expert-parallel constraint, whose experts' work must not be replicated)
is marked. CPU counts on
meta tensors, not speeds; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
from repro_torch.launch.dryrun import (JAX_FLOPS_BOUND,  # noqa: E402
                                       JAX_TEMP_BOUND, cost_extrapolated)

COLLECTIVE_BOUND = 2.0


def transform_of(fields: dict):
    """The config transform that sets ``fields`` (None for none)."""
    if not fields:
        return None
    return lambda cfg: cfg.replace(**fields)


def ratios(got: dict, ref: dict, ranks: int) -> dict:
    return {"F": got["flops"] / ref["flops"],
            "C": got["collective_bytes"]["total"]
            / max(ref["collective_bytes"]["total"], 1.0),
            "T": got["u2_temp_bytes"] / ref["u2_temp_bytes"],
            "E": got["flops"] * ranks / got["flops_global"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--golden", default=os.path.join(
        HERE, "tests", "golden_variants_jax.json"))
    ap.add_argument("--only", default="", help="VARIANT[,...]")
    args = ap.parse_args(argv)
    with open(args.golden) as f:
        data = json.load(f)
    mesh = tuple(int(v) for v in data["mesh"].split("x"))
    ranks = mesh[0] * mesh[1]
    bound = {"F": JAX_FLOPS_BOUND, "C": COLLECTIVE_BOUND,
             "T": JAX_TEMP_BOUND, "E": JAX_FLOPS_BOUND}
    print("| arch x shape | variant | donate | F | C | T | E | flops a rank "
          "| collective bytes | u2 temp bytes | s |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | "
          "--- |")
    for row in data["results"]:
        if args.only and row["variant"] not in args.only.split(","):
            continue
        t0 = time.time()
        got = cost_extrapolated(row["arch"], row["shape"], mesh,
                                cfg_transform=transform_of(row["replace"]),
                                donate=row["donate"])
        r = ratios(got, row["extrapolated"], ranks)
        held = dict(bound, E=bound["E"] if row["replace"].get(
            "moe_ep_constraint") else float("inf"))
        cells = [f"{v:.4f}" + (" (over)" if v > held[k] else "")
                 for k, v in r.items()]
        print(f"| {row['arch']} x {row['shape']} | {row['variant']} | "
              f"{row['donate']} | " + " | ".join(cells)
              + f" | {got['flops']:.4e} | "
              f"{got['collective_bytes']['total']:.4e} | "
              f"{got['u2_temp_bytes']:.4e} | {time.time() - t0:.1f} |",
              flush=True)
    for row in data["failures"]:
        print(f"| {row['arch']} x {row['shape']} | {row['variant']} | "
              f"{row['donate']} | the JAX package could not lower it: "
              f"{row['error'][:120]} |")


if __name__ == "__main__":
    main()
