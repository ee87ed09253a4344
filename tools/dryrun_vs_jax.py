#!/usr/bin/env python3
"""Hold the port's dry-run to the JAX package's, combination by combination.

    python3 tools/dryrun_vs_jax.py AFTER.json... [--before BEFORE.json...]
        [--golden tests/golden_dryrun_jax.json]

AFTER.json (and BEFORE.json, another commit's) is what
``python -m repro_torch.launch.dryrun --all --mesh both --out FILE`` writes
(several files, say one an arch, are read as one);
the golden is the JAX package's ``python -m repro.launch.dryrun --all
--mesh both --cost-extrapolate`` (see ``tests/test_torch_partition.py``).
Prints a markdown table, a row an arch and a column a shape, each cell
16x16 / 2x16x16: F, one rank's FLOPs over the JAX package's extrapolated
FLOPs a rank; C, the same of the collective bytes; T, one rank's
``temp_size_bytes`` over the JAX package's; with BEFORE.json each as
before -> after. Then the largest F, C and T, every combination whose F
exceeds ``JAX_FLOPS_BOUND`` or whose T exceeds ``JAX_TEMP_BOUND`` (of
``repro_torch.launch.dryrun``, which the tests and ``chip_smoke.py`` hold
too), and every one whose argument bytes differ between the two runs. CPU
counts on meta tensors, not speeds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
from repro_torch.launch.dryrun import (JAX_FLOPS_BOUND,  # noqa: E402
                                       JAX_TEMP_BOUND)

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("16x16", "2x16x16")


def load(*paths):
    rows = {}
    for path in paths:
        with open(path) as f:
            data = json.load(f)
        rows.update({(r["arch"], r["shape"], r["mesh"]): r
                     for r in data["results"]})
    return rows


def ratios(r, ref):
    ext = ref["extrapolated"]
    return (r["flops"] / ext["flops"],
            r["collective_bytes"]["total"]
            / max(ext["collective_bytes"]["total"], 1.0),
            r["memory"]["temp_size_bytes"]
            / ref["memory"]["temp_size_bytes"])


def cell(key_of, after, before, golden):
    parts = {"F": [], "C": [], "T": []}
    for mesh in MESHES:
        key = key_of(mesh)
        new = ratios(after[key], golden[key])
        old = ratios(before[key], golden[key]) if before else None
        for i, name in enumerate("FCT"):
            text = f"{new[i]:.2f}"
            if old is not None:
                text = f"{old[i]:.2f}->{text}"
            parts[name].append(text)
    return "; ".join(f"{n} {' / '.join(v)}" for n, v in parts.items())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("after", nargs="+")
    ap.add_argument("--before", nargs="*", default=[])
    ap.add_argument("--golden", default=os.path.join(
        HERE, "tests", "golden_dryrun_jax.json"))
    args = ap.parse_args(argv)
    after, golden = load(*args.after), load(args.golden)
    before = load(*args.before) if args.before else None
    archs = list(dict.fromkeys(a for a, _, _ in golden))
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("| --- |" + " --- |" * len(SHAPES))
    for arch in archs:
        cells = [cell(lambda m, s=s: (arch, s, m), after, before, golden)
                 for s in SHAPES]
        print(f"| {arch} | " + " | ".join(cells) + " |")
    got = {k: ratios(after[k], golden[k]) for k in golden}
    worst = [max((v[i], k) for k, v in got.items()) for i in range(3)]
    print(f"\n{len(after)} of {len(golden)} combinations; " + ", ".join(
        f"largest {n} {w[0]:.4f} {w[1]}" for n, w in zip("FCT", worst)))
    for n, i, bound in (("F", 0, JAX_FLOPS_BOUND), ("T", 2, JAX_TEMP_BOUND)):
        over = [(k, round(v[i], 4)) for k, v in got.items() if v[i] > bound]
        print(f"{n} over the bound {bound}: {over or 'none'}")
    if before:
        moved = [k for k in golden
                 if before[k]["memory"]["argument_size_bytes"]
                 != after[k]["memory"]["argument_size_bytes"]]
        print(f"argument bytes changed: {moved or 'none'}")


if __name__ == "__main__":
    main()
