#!/usr/bin/env python3
"""Time the RMSNorm, SSD-scan and RG-LRU kernels of two checkouts on one CUDA
card.

    python3 tools/compare_kernels.py OTHER_CHECKOUT [--reps 30]

Run from the root of a checkout; OTHER_CHECKOUT is the root of another
(say ``git archive`` of a parent commit, unpacked). Each checkout is
measured in a process of its own, with its own ``src`` first on the path
and its kernels built into its own ``build/kernels``, in turns: other,
this, this, other. A turn times, on the same seeded inputs:

- RMSNorm at x (8, 3072) and (64, 3072) bf16, the decode step's and the
  64-token prefill's shapes: the call between CUDA events (``ms``,
  ``chip_smoke.device_ms``), the kernel's own device time from
  ``torch.profiler`` (``kernel_us``), and the host's time per call over 200
  calls with no synchronize between them (``host_us``); where the checkout
  has ``add_rmsnorm``, the same for it, and ``x + r`` then ``rmsnorm``
  (``unfused_ms``);
- the SSD scan at mamba2-1.3b's 64-token bucket, x (1, 64, 64, 64), B/C
  (1, 64, 1, 128), chunk 64, and at (1, 256, 64, 64) with chunk 128, with
  its decay rates (A = linspace(1, 16)): ``ms`` and ``kernel_us``;
- the RG-LRU scan at recurrentgemma-9b's width, x (1, 64, 4096) and
  (1, 256, 4096) fp32: ``ms`` and ``kernel_us``; where the checkout has
  the fused form (``rglru_gated_scan``), the same for it at the 64-token
  prefill (1, 64, 4096) and the decode step (8, 1, 4096), bf16
  activations, and its function with the gate ops launched apart around
  the scan kernel (``unfused_ms``).

Prints one JSON line per checkout, shape and turn, each with the card's
name and power limit, then one line per shape with the better of each
checkout's two turns.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RMS_SHAPES = [(8, 3072), (64, 3072)]
SSD_SHAPES = [(1, 64, 64, 64, 1, 128, 64), (1, 256, 64, 64, 1, 128, 128)]
RGLRU_SHAPES = [(1, 64, 4096), (1, 256, 4096)]
GATED_SHAPES = [(1, 64, 4096), (8, 1, 4096)]


def measure(tree: str, label: str, reps: int) -> None:
    """One turn in this process: the kernels of ``tree``."""
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, ROOT)
    import torch
    from chip_smoke import (card_line, device_ms, gated_inputs,
                            gated_unfused, host_us, kernel_us, randn,
                            rglru_inputs, ssd_inputs)
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru as lru
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssd
    assert os.path.realpath(rms.__file__).startswith(os.path.realpath(tree))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    _build.build_all([n for n in ("rmsnorm", "ssd_scan", "rglru_scan")
                      if n in _build.SOURCES])
    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    names = ("rmsnorm", "ssd_scan", "rglru_scan")  # either tree's kernels

    def emit(**row):
        print(json.dumps(dict(row, tree=label, card=card)), flush=True)

    for R, D in RMS_SHAPES:
        x = randn(torch, gen, (R, D), bf)
        r = randn(torch, gen, (R, D), bf)
        w = (1.0 + 0.1 * randn(torch, gen, (D,), torch.float32)).to(bf)
        run = lambda: rms.rmsnorm(x, w)  # noqa: E731
        emit(kernel="rmsnorm", shape=[R, D], ms=device_ms(torch, run, reps),
             kernel_us=kernel_us(torch, run, reps, names),
             host_us=host_us(torch, run))
        if hasattr(rms, "add_rmsnorm"):
            run = lambda: rms.add_rmsnorm(x, r, w)  # noqa: E731
            emit(kernel="add_rmsnorm", shape=[R, D],
                 ms=device_ms(torch, run, reps),
                 kernel_us=kernel_us(torch, run, reps, names),
                 host_us=host_us(torch, run),
                 unfused_ms=device_ms(torch, lambda: rms.rmsnorm(x + r, w),
                                      reps))
    for (b, s, h, p, g, n, c) in SSD_SHAPES:
        args = ssd_inputs(torch, gen, b, s, h, p, g, n, mamba2_decay=True)
        run = lambda: ssd.ssd_scan(*args, chunk=c)  # noqa: E731
        emit(kernel="ssd_scan", shape=[b, s, h, p, g, n, c],
             ms=device_ms(torch, run, reps),
             kernel_us=kernel_us(torch, run, reps, names))
    for (B, S, W) in RGLRU_SHAPES:
        args = rglru_inputs(torch, gen, B, S, W)
        run = lambda: lru.rglru_scan(*args)  # noqa: E731
        emit(kernel="rglru_scan", shape=[B, S, W],
             ms=device_ms(torch, run, reps),
             kernel_us=kernel_us(torch, run, reps, names))
    if hasattr(lru, "rglru_gated_scan"):
        for (B, S, W) in GATED_SHAPES:
            args = gated_inputs(torch, gen, B, S, W, bf)
            run = lambda: lru.rglru_gated_scan(*args)  # noqa: E731
            emit(kernel="rglru_gated_scan", shape=[B, S, W],
                 ms=device_ms(torch, run, reps),
                 kernel_us=kernel_us(torch, run, reps, names),
                 unfused_ms=device_ms(
                     torch, lambda: gated_unfused(torch, lru, *args), reps))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="root of the checkout to compare with")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure, args.label, args.reps)
        return
    other = os.path.realpath(args.other)
    turns = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    rows = []
    for label, tree in turns:
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
        env.pop("REPRO_TORCH_BUILD_DIR", None)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.other,
             "--measure", tree, "--label", label, "--reps", str(args.reps)],
            env=env, cwd=tree, capture_output=True, text=True, timeout=600)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            sys.exit(f"compare_kernels: the {label} turn failed "
                     f"({out.returncode})")
        for line in out.stdout.splitlines():
            print(line, flush=True)
            rows.append(json.loads(line))
    keys = sorted({(r["kernel"], tuple(r["shape"])) for r in rows})
    for kernel, shape in keys:
        best = {}
        for label in ("other", "this"):
            mine = [r for r in rows if r["tree"] == label
                    and r["kernel"] == kernel and tuple(r["shape"]) == shape]
            if mine:
                best[label] = {k: min(r[k] for r in mine) for k in mine[0]
                               if k.endswith(("ms", "us"))}
        print(json.dumps(dict(kernel=kernel, shape=list(shape), best=best,
                              card=rows[0]["card"])), flush=True)


if __name__ == "__main__":
    main()
