#!/usr/bin/env python3
"""Time the RG-LRU kernel under launch plans other than the one it picks.

    python3 tools/rglru_plans.py [--reps 30]

Run from the root of a checkout, on one CUDA card. For each shape below,
the plan ``rglru.plan`` picks and a few others (lane tiles of 8 to 32,
chunks of 1 to 4 steps, time tiles of one to 32 chunks) are forced in turn
on the same seeded inputs. Each plan times the scan alone (fp32) and the
fused form (bf16 activations): the call between CUDA events (``ms``,
``chip_smoke.device_ms``) and the kernel's own device time from
``torch.profiler`` (``kernel_us``); the output must agree with the plain
version (scan and the fused form's state within 1e-5, the fused bf16
output within 2e-2). Prints one JSON line per shape and plan, each with the
card's name and power limit; ``picked`` marks the plan the kernel takes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, S, W): recurrentgemma-9b's 64-token prefill, a 256-token one, its
# decode step at max_batch 8, and a batch-8 prefill
SHAPES = [(1, 64, 4096), (1, 256, 4096), (8, 1, 4096), (8, 64, 4096)]
# (tile_w, chunk, chunks) tried beside the picked plan, where the S allows
OTHERS = [(32, 4, 8), (16, 2, 16), (16, 2, 32), (8, 4, 32), (32, 1, 1),
          (16, 1, 1)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    from chip_smoke import (card_line, device_ms, gated_inputs, kernel_us,
                            rglru_inputs)
    from repro_torch.kernels import rglru as lru
    if not torch.cuda.is_available():
        sys.exit("rglru_plans: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(5)
    picked_plan = lru.plan
    for (B, S, W) in SHAPES:
        scan = rglru_inputs(torch, gen, B, S, W)
        gated = gated_inputs(torch, gen, B, S, W, torch.bfloat16)
        ys_r, _ = lru.rglru_scan_plain(*scan)
        out_r, hl_r = lru.rglru_gated_scan_plain(*gated)
        picked = picked_plan(B, S, W, sms)
        plans = [picked] + [lru.Plan(*o) for o in OTHERS
                            if lru.Plan(*o) != picked
                            and (o[1] == 1) == (S == 1) and o[1] <= S
                            and o[0] * o[2] <= lru.MAX_THREADS]
        for p in plans:
            lru.plan = lambda *a, p=p: p
            try:
                ys, _ = lru.rglru_scan(*scan)
                out, hl = lru.rglru_gated_scan(*gated)
                ok = (torch.allclose(ys, ys_r, rtol=1e-5, atol=1e-5)
                      and torch.allclose(hl, hl_r, rtol=1e-5, atol=1e-5)
                      and torch.allclose(out.float(), out_r.float(),
                                         rtol=2e-2, atol=2e-2))
                row = dict(shape=[B, S, W], plan=p._asdict(),
                           picked=p == picked, blocks=p.blocks(B, W),
                           threads=p.threads, ok=ok, card=card)
                for name, fn, a in (("scan", lru.rglru_scan, scan),
                                    ("gated", lru.rglru_gated_scan, gated)):
                    run = lambda: fn(*a)  # noqa: E731
                    row[name] = dict(
                        ms=device_ms(torch, run, args.reps),
                        kernel_us=kernel_us(torch, run, args.reps,
                                            ("rglru_scan_kernel",)))
            finally:
                lru.plan = picked_plan
            print(json.dumps(row), flush=True)
            if not ok:
                sys.exit(f"rglru_plans: plan {p} disagrees with the plain "
                         "version")


if __name__ == "__main__":
    main()
