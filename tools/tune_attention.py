#!/usr/bin/env python3
"""Time the bf16 attention kernels on one CUDA card, beside SDPA.

    python3 tools/tune_attention.py [--reps 50]

Run from the root of a checkout. Flash prefill at llama3-3b's heads (24
over 8, head_dim 128, causal) at S = 64 (its largest prefill bucket) and
S = 384. Flash decode at llama3-3b's cache (8, 2048, 8, 128) and
recurrentgemma-9b's (8, 2048, 1, 256, 16 heads), with the validity
``chip_smoke.py`` times, at each chunk of slots per block that
``decode_attention.split_plan_mma`` may pick; then at the chunk it picks
with no valid slot at all, which leaves the two launches and little
else. Each call is timed with ``chip_smoke.py``'s ``device_ms`` in turns
with SDPA on the same inputs (SDPA, kernel, kernel, SDPA), and each kernel
it launches (decode's first pass and merge apart) by its own device time
from ``torch.profiler`` (``kernels_us``). Prints one JSON object per
measurement, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

CHUNKS = [64, 128, 256, 512, 1024]


def kernel_times(torch, fn, n: int = 20):
    """Mean device time (us) of each kernel ``fn`` launches, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:70]: e.self_device_time_total / e.count
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.count}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("tune_attention: needs a CUDA card")
    from chip_smoke import card_line, device_ms, randn
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", 0)
    card = card_line()
    _build.build_all(["flash_attention", "decode_attention"])
    gen = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16

    def emit(run, sdpa, **row):
        times = [device_ms(torch, f, reps=args.reps)
                 for f in (sdpa, run, run, sdpa)]
        print(json.dumps(dict(
            row, ms=min(times[1:3]), sdpa_ms=min(times[0], times[3]),
            turns=times, kernels_us=kernel_times(torch, run), card=card)),
            flush=True)

    for S in (64, 384):
        B, H, Hkv, D = 1, 24, 8, 128
        q = randn(torch, gen, (B, S, H, D), bf)
        k = randn(torch, gen, (B, S, Hkv, D), bf)
        v = randn(torch, gen, (B, S, Hkv, D), bf)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        emit(lambda: fa.flash_attention(q, k, v),
             lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True),
             kernel="flash_attention", shape=[B, S, H, Hkv, D])

    picked = dec.split_plan_mma
    for (B, T, H, Hkv, D), max_len in (((8, 2048, 24, 8, 128), 2048),
                                       ((8, 2048, 16, 1, 256), 4095)):
        q = randn(torch, gen, (B, 1, H, D), bf)
        kc = randn(torch, gen, (B, T, Hkv, D), bf)
        vc = randn(torch, gen, (B, T, Hkv, D), bf)
        lengths = torch.randint(1, max_len + 1, (B,), generator=gen,
                                device=dev)
        valid = torch.arange(T, device=dev)[None] < lengths[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kc, vc))
        for chunk in CHUNKS + [None]:
            dec.split_plan_mma = picked if chunk is None else (
                lambda rows, T_, sms, D_, c=chunk: (c, -(-T_ // c)))
            # the picked chunk once more, with no valid slot
            ok = torch.zeros_like(valid) if chunk is None else valid
            mask = ok[:, None, None, :]
            emit(lambda: dec.decode_attention(q, kc, vc, ok),
                 lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, attn_mask=mask, enable_gqa=True),
                 kernel="decode_attention", shape=[B, T, H, Hkv, D],
                 valid=int(ok.sum()),
                 chunk=chunk or picked(B * Hkv, T, dec._num_sms(0), D)[0])
        dec.split_plan_mma = picked


if __name__ == "__main__":
    main()
