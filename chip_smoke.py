#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It imports the port only (never JAX or
the JAX package ``repro``), needs one CUDA card, and exits non-zero on any
failure, or when there is no card or no checkout beside it. Phases:

1. Environment: the card's name and power limit, the kernel build (one
   ``nvcc`` per CUDA source, all five at once), and each kernel's
   registers and spill bytes from ptxas's report.
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, on the sweep shapes of ``tests/test_kernels.py`` and on the
   serving paths' shapes, at 2e-5 (fp32) and 2e-2 (bf16) elementwise, bf16
   also at BF16_REL_L2 over the whole output, the SSD scan at 2e-4 and the
   RG-LRU scan at 1e-5 (its fused form's fp32 output and state too); the
   fused RMSNorm's residual sum must equal ``x + r`` bit for bit. Then each
   timed with CUDA events beside its plain version and, where one exists,
   one PyTorch library call, with its time over the library call's
   (``x_library``) and over its bound (``x_bound``), and its own device
   time from ``torch.profiler`` (``kernel_us``); RMSNorm also by the host's
   time per call (``host_us``); the fused RMSNorm beside the add and the
   norm launched apart, and the fused RG-LRU form beside the scan kernel
   with its gate ops launched apart (``unfused_ms``).
   The MoE expert products (bf16 GEMMs with fp32 outputs) at
   deepseek-v2-lite-16b's widths against fp64, as exact as the widened
   fp32 product, and timed beside it.
3. Models: full-width llama3-3b, mamba2-1.3b, recurrentgemma-9b,
   deepseek-v2-lite-16b (MoE with MLA) and llama4-scout-17b-a16e (MoE,
   GQA 40/8, cut to 2 layers) from a seeded generator, one at a time;
   fp32 logits through the kernels against the plain versions
   (recurrentgemma-9b cut to 5 layers: a unit and the tail; deepseek to 3:
   its dense layer and two MoE layers), the prefill->decode contract, and
   bf16 judged against fp32, at 2 layers (a hybrid: 5) and at full depth.
   An MoE model's bf16 check prints the share of routing choices on which
   the kernels and the plain versions agree, and holds the tokens that no
   routing flip between them reaches (a flip moves its token by O(1), not
   by a rounding); where a flip reaches every token at full depth, the
   2-layer check is the gate.
4. Graphs and serve: for each of the five models, a ``TorchBackend``
   (which captures its decode step and a forward a prefill bucket as CUDA
   graphs) in fp32 at phase 3's depth and in bf16 at full depth; each
   graph's replays against the eager step it captured, bit for bit
   (``torch.equal``): three decode steps of random tokens from a random
   cache (logits and every cache tensor; recurrentgemma-9b's rows cross
   its 2048-slot ring) and every prefill bucket. Then ``InferenceEngine``
   + the bf16 backend + the AGFT tuner over 8 ``normal`` requests, the
   launch counts set to 0 before and read after; each kernel of a model's
   path must have run there, as many times as the path says (a replay
   counts the launches its capture recorded), and as many RMSNorm
   launches must have taken the residual add in, and as many RG-LRU launches the recurrent block's
   gates, over a prefill and over a decode step. The same 8 requests are
   served again under ``static`` at f_max from a zeroed cache, with the
   same checks, and each run's energy per token and EDP (the DVFS model's)
   are printed. Last, a decode step and the largest prefill bucket's
   forward traced and timed, eager and as a graph; each trace must hold
   as many of the port's kernels as the launch counts say ran (a replay:
   as many as its capture recorded), or it is taken again, 5 times in
   all, before the run fails.
5. The paper's workload: the whole 30 s Azure 2024 trace (seed 0; prompt
   and output lengths as drawn, nothing cut) through ``InferenceEngine``
   on one bf16 ``TorchBackend`` of full-width llama3-3b (all 28 layers),
   four times from a zeroed cache: under ``agft``, ``agft-2d``,
   ``greenllm-rule`` (the two phased policies; the backend has no
   ``execute_phased``, so each iteration runs at its dominant phase's
   clock) and ``static`` at f_max, each at the registry's default 0.8 s
   window. Each run prints the serve CLI's summary
   (``repro_torch.launch.serve.summarize``), energy per token, its
   iterations, forwards and decode steps, the median graphed decode step,
   its wall time and its frequency history. It fails unless every request
   finishes at its own length, every policy decided (AGFT for at least one
   round), the phased policies left the engine in phased mode (every
   ``agft-2d`` decision a ``(f_prefill, f_decode)`` pair), and each
   kernel launched as the path says.

The last lines are a JSON object with each kernel's numbers (a row per
kernel and timed shape; its launches are those of the serve runs whose
path runs that shape, also given per model, phase 5's under
``"llama3-3b azure"``) and the result line ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # fp32: no tensor core

# (rtol, atol): kernels as in tests/test_kernels.py; the fp32 model's
# prefill and decode against its forward as in tests/test_models_smoke.py
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2),
       "ssd": (2e-4, 2e-4), "rglru": (1e-5, 1e-5),
       "prefill": (2e-4, 2e-4), "decode": (1e-3, 1e-3)}
FP32_REL_L2 = 1e-4       # fp32 logits, kernels vs plain versions
# bf16 kernels vs plain versions, over the whole output: both accumulate in
# fp32 and round once, so they differ only where the rounding of an output
# flips (about 1e-4); a fault in the bf16 loads or stores gives O(1)
BF16_REL_L2 = 1e-3
BF16_VS_PLAIN = 1.5      # bf16 kernels' distance from fp32 / plain bf16's

SWEEP_FLASH = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 256, 4, 1, 128),
               (2, 384, 6, 2, 64)]
MAIN_FLASH = [(1, S, 24, 8, 128) for S in (1, 16, 40, 64)]
# llama4-scout-17b-a16e's prefill: 40 query heads over 8 kv heads (G = 5)
G5_FLASH = [(1, S, 40, 8, 128) for S in (1, 16, 40, 64)]
SWEEP_DECODE = [(1, 512, 4, 4, 64), (2, 1024, 8, 2, 64), (4, 512, 4, 1, 128)]
MAIN_DECODE = (8, 2048, 24, 8, 128)
G5_DECODE = (8, 2048, 40, 8, 128)
SWEEP_RMS = [(4, 128), (2, 17, 256), (3, 5, 7, 512)]
MAIN_RMS = [(8, 3072), (64, 3072)]
# the other models' rows: d_model 2048 (mamba2-1.3b, deepseek-v2-lite-16b),
# 4096 (recurrentgemma-9b), 5120 (llama4-scout-17b-a16e)
MORE_RMS = [(n, d) for d in (2048, 4096, 5120) for n in (8, 64)]
HOST_CALLS = 200         # RMSNorm launches timed on the host's clock
# keys of some rows only: RMSNorm's host time per call, and the fused
# RMSNorm's time with the add and the norm launched apart
OPTIONAL = ("host_us", "unfused_ms")
# recurrentgemma-9b's decode: 16 query heads over 1 kv head at head_dim
# 256, against the 2048-slot ring of its local attention
WIDE_DECODE = (8, 2048, 16, 1, 256)
# (b, s, h, p, g, n, chunk): the test_ssd_sweep shapes; mamba2-1.3b's
# prefill buckets of 1, 2 and 64 tokens (chunk = s); and 256 (chunk 128)
SWEEP_SSD = [(1, 128, 4, 64, 1, 64, 32), (2, 256, 8, 32, 2, 32, 64),
             (1, 64, 2, 64, 1, 128, 16), (1, 256, 64, 64, 1, 128, 128),
             (8, 64, 64, 64, 1, 128, 64)]
MAIN_SSD = [(1, s, 64, 64, 1, 128, s) for s in (1, 2, 64)]
LONG_SSD = (1, 256, 64, 64, 1, 128, 128)   # two chunks of the config's 128
# (B, S, W): the test_rglru_sweep shapes; recurrentgemma-9b's width
SWEEP_RGLRU = [(1, 64, 128), (2, 256, 256), (3, 128, 384)]
MAIN_RGLRU = [(1, 64, 4096), (1, 256, 4096)]
# the fused RG-LRU form at recurrentgemma-9b's 64-token and 2-token prefill
# buckets, and at its decode step (max_batch 8, one token)
MAIN_GATED = [(1, 64, 4096), (1, 2, 4096)]
STEP_GATED = (8, 1, 4096)
MODELS = ("llama3-3b", "mamba2-1.3b", "recurrentgemma-9b",
          "deepseek-v2-lite-16b", "llama4-scout-17b-a16e")
# llama4-scout-17b-a16e at full width is 216 GB in bf16: one card holds
# it cut to 2 of its 48 layers (12.9 GB)
DEPTH = {"llama4-scout-17b-a16e": 2}
# the fp32 kernels-vs-plain check (and the fp32 backend of phase 4) at a
# cut depth: recurrentgemma-9b's one (rec, rec, attn) unit and the
# two-layer tail; deepseek-v2-lite-16b's dense layer and two MoE layers.
# The bf16 checks run the whole depth
FP32_LAYERS = {"recurrentgemma-9b": 5, "deepseek-v2-lite-16b": 3}
# the shallow bf16 check: 2 layers (a hybrid: a unit and its tail), where
# a rounding flip has not yet grown through the depth
BF16_CUT_LAYERS = 2
# phase 5: the whole of this Azure trace, served by llama3-3b at full width
# and depth under each policy, from a zeroed cache
AZURE = {"duration_s": 30.0, "base_rate": 1.0, "year": 2024, "seed": 0}
AZURE_POLICIES = ("agft", "agft-2d", "greenllm-rule", "static")
AZURE_RUN = "llama3-3b azure"      # phase 5's key in the kernels line
# each timed row of the kernels line: its kernel, and the serve runs whose
# path launches that kernel at the row's shape (the row counts theirs)
ROWS = {"rmsnorm": ("rmsnorm", MODELS + (AZURE_RUN,)),
        "add_rmsnorm": ("rmsnorm_fused", MODELS + (AZURE_RUN,)),
        "flash_attention": ("flash_attention", ("llama3-3b", AZURE_RUN)),
        "flash_attention_g5": ("flash_attention",
                               ("llama4-scout-17b-a16e",)),
        "decode_attention": ("decode_attention", ("llama3-3b", AZURE_RUN)),
        "decode_attention_g5": ("decode_attention",
                                ("llama4-scout-17b-a16e",)),
        "decode_attention_d256_g16": ("decode_attention",
                                      ("recurrentgemma-9b",)),
        "ssd_scan": ("ssd_scan", ("mamba2-1.3b",)),
        "ssd_scan_c128": ("ssd_scan", ()),
        "rglru_scan": ("rglru_scan", ("recurrentgemma-9b",)),
        "rglru_gated_scan": ("rglru_gated", ("recurrentgemma-9b",)),
        "rglru_gated_scan_step": ("rglru_gated_step",
                                  ("recurrentgemma-9b",))}
# the rmsnorm row counts every launch of the RMSNorm kernel, the
# add_rmsnorm row those among them that took the residual add in; the
# rglru_scan row every launch of the RG-LRU kernel, the two rglru_gated
# rows those of its fused form over a prefill and over a decode step; the
# serve runs prefill at most 64 tokens, so no serve launch is at the
# chunk-128 SSD row's shape

# traces taken before a short one fails the run, a second apart: on the
# H100 the profiler has lost every kernel of three traces in a row
TRACE_TRIES = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def close(torch, got, want, dtype_name):
    """(max abs error, ok) under the dtype's (rtol, atol)."""
    rtol, atol = TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= atol + rtol * w.abs()).all())
    return float(err.max()), ok


def rel_l2(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def device_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call, in ms, from CUDA events. A sleep
    kernel enqueued first keeps the card busy while the host enqueues the
    call, so the events bracket device work, not host overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def port_events(events):
    """The device kernels of the port among a profiler's
    ``key_averages()``, by ``repro_torch.kernels.DEVICE_KERNELS``."""
    from torch.autograd import DeviceType
    from repro_torch.kernels import DEVICE_KERNELS
    names = [n for _, group in DEVICE_KERNELS.values() for n in group]
    return [e for e in events if e.device_type != DeviceType.CPU
            and any(n in e.key for n in names)]


def traced(torch, fn, calls: int, cpu: bool = False):
    """``torch.profiler`` over ``calls`` calls of ``fn``
    (``kernels.profile_calls``, after a warm-up step): its
    ``key_averages()`` and the wall time of one call in s. A trace is kept
    only if it holds, of each group of the port's kernels
    (``DEVICE_KERNELS``), as many as the launch counts rose by over those
    calls, a graph's replay by what its capture recorded. The profiler has
    dropped kernels of a trace on the H100, now and then all of them: a
    trace short of them is taken again, ``TRACE_TRIES`` times in all, a
    second apart, then the run fails."""
    from repro_torch.kernels import (device_launches, profile_calls,
                                     traced_launches)
    for attempt in range(TRACE_TRIES):
        events, risen, wall = profile_calls(fn, calls, cpu)
        want = device_launches(risen)
        seen = traced_launches(events)
        if seen == want:
            return events, wall
        say(f"  trace {attempt + 1} of {TRACE_TRIES} is short: the profiler "
            f"saw {seen} of the port's kernels, the counts say {want}")
        time.sleep(1.0)
    fail(f"the profiler missed kernels that ran in {TRACE_TRIES} traces")


def kernel_us(torch, fn, reps: int = 30) -> float:
    """The device time of the port's kernels that one call of ``fn``
    launches, in us, from a trace of ``reps`` calls that holds every one of
    them (``traced``). Unlike ``device_ms`` it leaves out the launch gaps
    and the event pair."""
    events, _ = traced(torch, fn, reps)
    return sum(e.self_device_time_total for e in port_events(events)) / reps


def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """The host's time per call, in us, over ``calls`` calls enqueued with
    no synchronize between them (after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def randn(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(torch, dev):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as lru
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssd
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    failures = []
    main_err = dict.fromkeys(ROWS, 0.0)

    def record(name, case, dn, got, want, main, tol=None):
        err, ok = close(torch, got, want, tol or dn)
        rel = ""
        if dn == "bfloat16":
            e_rel = rel_l2(torch, got, want)
            ok = ok and e_rel <= BF16_REL_L2
            rel = f" rel_l2={e_rel:.3e}"
        say(f"  {name:16s} {case:34s} {dn:8s} max_abs_err={err:.3e}{rel}"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} {case} {dn}")
        # the main path's error: bf16 where the path runs bf16, else fp32
        if main and (dn == "bfloat16" or tol):
            main_err[name] = max(main_err[name], err)

    def decode_case(B, T, H, Hkv, D, dt, dn, valid, main,
                    row="decode_attention"):
        q = randn(torch, gen, (B, 1, H, D), dt)
        kc = randn(torch, gen, (B, T, Hkv, D), dt)
        vc = randn(torch, gen, (B, T, Hkv, D), dt)
        if main:
            valid[-1] = False                     # the all-invalid row
        got = dec.decode_attention(q, kc, vc, valid)
        record(row, f"B{B} T{T} H{H} Hkv{Hkv} D{D}", dn,
               got, dec.decode_attention_plain(q, kc, vc, valid), main)
        if main and bool(got[-1].float().abs().max() != 0):
            failures.append(f"decode all-invalid row not 0 (D{D} {dn})")

    for dn, dt in dtypes.items():
        for shape in SWEEP_RMS + MAIN_RMS + MORE_RMS:
            x = randn(torch, gen, shape, dt)
            r = randn(torch, gen, shape, dt)
            w = (1.0 + 0.1 * randn(torch, gen, (shape[-1],),
                                   torch.float32)).to(dt)
            record("rmsnorm", str(shape), dn, rms.rmsnorm(x, w),
                   rms.rmsnorm_plain(x, w), shape in MAIN_RMS)
            s_k, y_k = rms.add_rmsnorm(x, r, w)
            if not torch.equal(s_k, x + r):
                failures.append(f"add_rmsnorm {shape} {dn}: s != x + r")
            record("add_rmsnorm", str(shape), dn, y_k,
                   rms.add_rmsnorm_plain(x, r, w)[1], shape in MAIN_RMS)
        for (B, S, H, Hkv, D) in SWEEP_FLASH + MAIN_FLASH + G5_FLASH:
            q = randn(torch, gen, (B, S, H, D), dt)
            k = randn(torch, gen, (B, S, Hkv, D), dt)
            v = randn(torch, gen, (B, S, Hkv, D), dt)
            g5 = (B, S, H, Hkv, D) in G5_FLASH
            record("flash_attention_g5" if g5 else "flash_attention",
                   f"B{B} S{S} H{H} Hkv{Hkv} D{D}", dn,
                   fa.flash_attention(q, k, v, causal=True),
                   fa.flash_attention_plain(q, k, v, causal=True),
                   g5 or (B, S, H, Hkv, D) in MAIN_FLASH)
        for (B, T, H, Hkv, D) in SWEEP_DECODE + [MAIN_DECODE, G5_DECODE]:
            lengths = torch.randint(1, T + 1, (B,), generator=gen,
                                    device=dev)
            valid = torch.arange(T, device=dev)[None] < lengths[:, None]
            shape = (B, T, H, Hkv, D)
            decode_case(B, T, H, Hkv, D, dt, dn, valid,
                        shape in (MAIN_DECODE, G5_DECODE),
                        "decode_attention_g5" if shape == G5_DECODE
                        else "decode_attention")
        # recurrentgemma-9b's ring: rows that wrapped it (every slot live)
        # and rows that did not (a prefix), one row with no valid slot
        B, T, H, Hkv, D = WIDE_DECODE
        lengths = torch.randint(1, 2 * T, (B,), generator=gen, device=dev)
        valid = torch.arange(T, device=dev)[None] < lengths[:, None]
        decode_case(B, T, H, Hkv, D, dt, dn, valid, True,
                    "decode_attention_d256_g16")
    # extra cases of the sweep file: non-causal flash, ring-buffer decode
    q = randn(torch, gen, (2, 128, 4, 64), torch.float32)
    k = randn(torch, gen, (2, 128, 2, 64), torch.float32)
    v = randn(torch, gen, (2, 128, 2, 64), torch.float32)
    record("flash_attention", "non-causal B2 S128 H4 Hkv2 D64", "float32",
           fa.flash_attention(q, k, v, causal=False),
           fa.flash_attention_plain(q, k, v, causal=False), False)
    for (B, T, H, Hkv, D), row in (
            ((2, 512, 4, 2, 64), "decode_attention"),
            (WIDE_DECODE, "decode_attention_d256_g16")):
        q = randn(torch, gen, (B, 1, H, D), torch.float32)
        kc = randn(torch, gen, (B, T, Hkv, D), torch.float32)
        vc = randn(torch, gen, (B, T, Hkv, D), torch.float32)
        valid = torch.rand((B, T), generator=gen, device=dev) < 0.7
        record(row, f"ring-buffer B{B} T{T} H{H} Hkv{Hkv} "
               f"D{D}", "float32", dec.decode_attention(q, kc, vc, valid),
               dec.decode_attention_plain(q, kc, vc, valid), False)
    # the two scans, fp32 as their callers give them
    for (b, s, h, p, g, n, chunk) in SWEEP_SSD + MAIN_SSD:
        main = (b, s, h, p, g, n, chunk) in MAIN_SSD
        args = ssd_inputs(torch, gen, b, s, h, p, g, n, mamba2_decay=main)
        y, st = ssd.ssd_scan(*args, chunk=chunk)
        y_r, st_r = ssd.ssd_scan_plain(*args)
        case = f"b{b} s{s} h{h} p{p} g{g} n{n} c{chunk}"
        row = ("ssd_scan_c128" if (b, s, h, p, g, n, chunk) == LONG_SSD
               else "ssd_scan")
        main = main or row == "ssd_scan_c128"
        record(row, case + " y", "float32", y, y_r, main, "ssd")
        record(row, case + " state", "float32", st, st_r, main, "ssd")
    for (B, S, W) in SWEEP_RGLRU + MAIN_RGLRU:
        args = rglru_inputs(torch, gen, B, S, W)
        ys, hl = lru.rglru_scan(*args)
        ys_r, hl_r = lru.rglru_scan_plain(*args)
        main = (B, S, W) in MAIN_RGLRU
        record("rglru_scan", f"B{B} S{S} W{W} ys", "float32", ys, ys_r,
               main, "rglru")
        record("rglru_scan", f"B{B} S{S} W{W} h_last", "float32", hl, hl_r,
               main, "rglru")
    # the fused form, fp32 and bf16 activations (the served dtype)
    for dn, dt in dtypes.items():
        for (B, S, W) in SWEEP_RGLRU + MAIN_GATED + [STEP_GATED]:
            args = gated_inputs(torch, gen, B, S, W, dt)
            out, hl = lru.rglru_gated_scan(*args)
            out_r, hl_r = lru.rglru_gated_scan_plain(*args)
            row = ("rglru_gated_scan_step" if (B, S, W) == STEP_GATED
                   else "rglru_gated_scan")
            main = (B, S, W) in MAIN_GATED + [STEP_GATED]
            record(row, f"B{B} S{S} W{W} out", dn, out, out_r, main,
                   "rglru" if dn == "float32" else None)
            record(row, f"B{B} S{S} W{W} h_last", "float32", hl, hl_r, main,
                   "rglru")
    torch.cuda.synchronize()
    if failures:
        fail("kernels disagree with their plain versions: "
             + "; ".join(failures))
    return main_err


def ssd_inputs(torch, gen, b, s, h, p, g, n, mamba2_decay=False):
    """The distributions of tests/test_kernels.py::test_ssd_sweep; with
    ``mamba2_decay`` the decay rates of mamba2-1.3b's init instead,
    A = linspace(1, 16) over the heads."""
    F = torch.nn.functional
    x = randn(torch, gen, (b, s, h, p), torch.float32)
    dt = F.softplus(randn(torch, gen, (b, s, h), torch.float32))
    A = torch.exp(0.3 * randn(torch, gen, (h,), torch.float32))
    if mamba2_decay:
        A = torch.linspace(1.0, 16.0, h, device=gen.device)
    B = 0.5 * randn(torch, gen, (b, s, g, n), torch.float32)
    C = 0.5 * randn(torch, gen, (b, s, g, n), torch.float32)
    return x, dt, A, B, C


def rglru_inputs(torch, gen, B, S, W):
    """The distributions of tests/test_kernels.py::test_rglru_sweep."""
    F = torch.nn.functional
    x = randn(torch, gen, (B, S, W), torch.float32)
    log_a = -F.softplus(randn(torch, gen, (B, S, W), torch.float32))
    h0 = randn(torch, gen, (B, W), torch.float32)
    return x, log_a, h0


def gated_inputs(torch, gen, B, S, W, dtype):
    """The fused RG-LRU form's inputs: xc, the gate pre-activations, the y
    branch (in the activation dtype) and h0 from unit normals, lambda from
    the block's init, 0.9 + 0.099 U(0, 1)."""
    xc, pre_i, pre_r = (randn(torch, gen, (B, S, W), torch.float32)
                        for _ in range(3))
    lam = 0.9 + 0.099 * torch.rand((W,), generator=gen, device=gen.device)
    return (xc, pre_i, pre_r, lam, randn(torch, gen, (B, S, W), dtype),
            randn(torch, gen, (B, W), torch.float32))


def gated_unfused(torch, lru, xc, pre_i, pre_r, lam, pre_y, h0):
    """The fused form's function with its gate ops launched apart around
    the scan kernel, as the recurrent block ran before it took them in."""
    F = torch.nn.functional
    log_a = -8.0 * F.softplus(lam) * torch.sigmoid(pre_r)
    ys, h_last = lru.rglru_scan(torch.sigmoid(pre_i) * xc, log_a, h0)
    yb = F.gelu(pre_y.float(), approximate="tanh")
    return (ys * yb).to(pre_y.dtype), h_last


def time_kernels(torch, dev, main_err):
    """Each kernel at its main-path shape (bf16): kernel, plain version and
    one library call, with the bound from this run's inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as lru
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssd
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    rows = []

    def lib_ms(fn, what):
        try:
            return device_ms(torch, fn)
        except (RuntimeError, TypeError) as e:   # no such library call here
            say(f"  library call for {what} unavailable: {e}")
            return None

    # rmsnorm at the decode step's shape: 8 rows of 3072, alone and with
    # the residual add taken in
    R, D = MAIN_RMS[0]
    x = randn(torch, gen, (R, D), bf)
    r = randn(torch, gen, (R, D), bf)
    w = (1.0 + 0.1 * randn(torch, gen, (D,), torch.float32)).to(bf)
    nbytes = 2 * R * D * 2 + D * 2
    b_ms, b_by = bound_ms(nbytes, 4.0 * R * D, "float32")
    rows.append(dict(
        name="rmsnorm", route="cuda",
        source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:23",
        shape=f"x ({R}, {D}) bf16",
        ms=device_ms(torch, lambda: rms.rmsnorm(x, w)),
        plain_ms=device_ms(torch, lambda: rms.rmsnorm_plain(x, w)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms(lambda: F.rms_norm(x, (D,), w, 1e-6),
                          "rmsnorm"),
        kernel_us=kernel_us(torch, lambda: rms.rmsnorm(x, w)),
        host_us=host_us(torch, lambda: rms.rmsnorm(x, w))))
    # x, r, s, y and the weight, each once; the add and the norm
    nbytes = 4 * R * D * 2 + D * 2
    b_ms, b_by = bound_ms(nbytes, 5.0 * R * D, "float32")
    say("  library call for add_rmsnorm: none (no single PyTorch call "
        "adds the residual and takes the norm)")
    rows.append(dict(
        name="add_rmsnorm", route="cuda",
        source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:23",
        shape=f"x, r ({R}, {D}) bf16",
        ms=device_ms(torch, lambda: rms.add_rmsnorm(x, r, w)),
        plain_ms=device_ms(torch, lambda: rms.add_rmsnorm_plain(x, r, w)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        unfused_ms=device_ms(torch, lambda: rms.rmsnorm(x + r, w)),
        kernel_us=kernel_us(torch, lambda: rms.add_rmsnorm(x, r, w)),
        host_us=host_us(torch, lambda: rms.add_rmsnorm(x, r, w))))
    # flash prefill at the largest prefill bucket: llama3-3b's 24 query
    # heads over 8, llama4-scout-17b-a16e's 40 over 8
    for row, (B, S, H, Hkv, Dh) in (("flash_attention", MAIN_FLASH[-1]),
                                    ("flash_attention_g5", G5_FLASH[-1])):
        q = randn(torch, gen, (B, S, H, Dh), bf)
        k = randn(torch, gen, (B, S, Hkv, Dh), bf)
        v = randn(torch, gen, (B, S, Hkv, Dh), bf)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        nbytes = 2 * (2 * B * S * H * Dh + 2 * B * S * Hkv * Dh)
        flops = 4.0 * B * H * Dh * S * (S + 1) / 2
        b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
        rows.append(dict(
            name=row, route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:65",
            shape=f"q ({B}, {S}, {H}, {Dh}), kv heads {Hkv}, causal, bf16",
            ms=device_ms(torch, lambda: fa.flash_attention(q, k, v)),
            plain_ms=device_ms(torch,
                               lambda: fa.flash_attention_plain(q, k, v)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), "flash"),
            kernel_us=kernel_us(torch, lambda: fa.flash_attention(q, k, v))))
    def decode_timing(shape, max_len):
        """The decode kernel against a cache of ragged validity: each row
        holds 1..max_len tokens (past T: a ring that wrapped, all live)."""
        B, T, H, Hkv, Dh = shape
        q = randn(torch, gen, (B, 1, H, Dh), bf)
        kc = randn(torch, gen, (B, T, Hkv, Dh), bf)
        vc = randn(torch, gen, (B, T, Hkv, Dh), bf)
        lengths = torch.randint(1, max_len + 1, (B,), generator=gen,
                                device=dev)
        valid = torch.arange(T, device=dev)[None] < lengths[:, None]
        n_valid = int(valid.sum())
        nbytes = 2 * (2 * B * H * Dh) + B * T + 2 * n_valid * Hkv * Dh * 2
        b_ms, b_by = bound_ms(nbytes, 4.0 * n_valid * H * Dh, "bfloat16")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kc, vc))
        mask = valid[:, None, None, :]
        return dict(
            shape=f"q ({B}, 1, {H}, {Dh}), cache ({B}, {T}, {Hkv}, {Dh}), "
                  f"{n_valid} valid slots, bf16",
            ms=device_ms(torch,
                         lambda: dec.decode_attention(q, kc, vc, valid)),
            plain_ms=device_ms(
                torch, lambda: dec.decode_attention_plain(q, kc, vc, valid)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), "decode"),
            kernel_us=kernel_us(
                torch, lambda: dec.decode_attention(q, kc, vc, valid)))

    # decode at llama3-3b's cache shape, at llama4-scout-17b-a16e's (40
    # query heads over 8), and at recurrentgemma-9b's (16 query heads over
    # 1 kv head at head_dim 256, a 2048-slot ring)
    for row, shape, max_len in (
            ("decode_attention", MAIN_DECODE, MAIN_DECODE[1]),
            ("decode_attention_g5", G5_DECODE, G5_DECODE[1]),
            ("decode_attention_d256_g16", WIDE_DECODE,
             2 * WIDE_DECODE[1] - 1)):
        rows.append(dict(
            name=row, route="cuda",
            source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:57",
            **decode_timing(shape, max_len)))
    # SSD at mamba2-1.3b's largest prefill bucket (64 tokens, chunk 64),
    # and at 256 tokens in two chunks of the config's 128. The bound counts
    # the products the function needs, in fp32 (the CUDA cores' rate: the
    # 3xTF32 products do fp32 work): C.B^T on the causal half once per
    # (batch, group, chunk), as the heads of a group share it; per head
    # att.x on the causal half, the state update, and C.S_prev for every
    # chunk but the first, whose incoming state is 0
    say("  library call for ssd_scan: none (no single PyTorch call "
        "computes the chunked SSD scan)")
    for row, (b, s, h, p, g, n, c) in (("ssd_scan", MAIN_SSD[-1]),
                                       ("ssd_scan_c128", LONG_SSD)):
        args = ssd_inputs(torch, gen, b, s, h, p, g, n, mamba2_decay=True)
        nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n
                      + b * h * p * n)
        tri = s // c * c * (c + 1) / 2
        flops = 2.0 * b * (g * tri * n
                           + h * (tri * p + s * p * n + (s - c) * p * n))
        b_ms, b_by = bound_ms(nbytes, flops, "float32")
        ps = ssd.plan(b, s, h, p, g, n, c,
                      torch.cuda.get_device_properties(0)
                      .multi_processor_count)[0]
        rows.append(dict(
            name=row, route="cuda",
            source="src/repro_torch/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd.py:66",
            shape=f"x ({b}, {s}, {h}, {p}), B/C ({b}, {s}, {g}, {n}), "
                  f"chunk {c}, fp32; {b * h * -(-p // ps)} blocks of P-slice "
                  f"{ps}, clusters of "
                  f"{ssd.cluster_size(b, s, h, p, g, n, c)}",
            ms=device_ms(torch, lambda: ssd.ssd_scan(*args, chunk=c)),
            plain_ms=device_ms(torch, lambda: ssd.ssd_scan_plain(*args)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            kernel_us=kernel_us(torch,
                                lambda: ssd.ssd_scan(*args, chunk=c))))
    # RG-LRU at recurrentgemma-9b's largest prefill bucket: exp, the
    # clip, sqrt and two products a step, each counted as one operation
    B, S, W = MAIN_RGLRU[0]
    args = rglru_inputs(torch, gen, B, S, W)
    nbytes = 4 * (3 * B * S * W + 2 * B * W)
    b_ms, b_by = bound_ms(nbytes, 8.0 * B * S * W, "float32")
    say("  library call for rglru_scan: none (no single PyTorch call "
        "computes a gated linear recurrence)")
    rows.append(dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru.py:51",
        shape=f"x, log_a ({B}, {S}, {W}), fp32; "
              f"{plan_note(torch, lru, B, S, W)}",
        ms=device_ms(torch, lambda: lru.rglru_scan(*args)),
        plain_ms=device_ms(torch, lambda: lru.rglru_scan_plain(*args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        kernel_us=kernel_us(torch, lambda: lru.rglru_scan(*args))))
    # the fused form at the 64-token prefill and at the decode step, bf16
    # activations: reads xc, pre_i, pre_r (fp32), pre_y (bf16), lambda and
    # h0, writes out (bf16) and h_last; per element the scan's 8 operations
    # and 18 of the gates (two sigmoids of 3, two products, gelu_tanh of 9,
    # the output product), each counted as one
    say("  library call for rglru_gated_scan: none (no single PyTorch call "
        "computes the recurrent block's gates and recurrence)")
    for row, (B, S, W) in (("rglru_gated_scan", MAIN_GATED[0]),
                           ("rglru_gated_scan_step", STEP_GATED)):
        args = gated_inputs(torch, gen, B, S, W, bf)
        n = B * S * W
        b_ms, b_by = bound_ms(4 * 3 * n + 2 * 2 * n + 4 * W + 4 * 2 * B * W,
                              26.0 * n, "float32")
        rows.append(dict(
            name=row, route="cuda",
            source="src/repro_torch/csrc/rglru_scan.cu",
            replaces="src/repro/kernels/rglru.py:51",
            shape=f"xc, pre_i, pre_r ({B}, {S}, {W}) fp32, pre_y bf16, out "
                  f"bf16; {plan_note(torch, lru, B, S, W)}",
            ms=device_ms(torch, lambda: lru.rglru_gated_scan(*args)),
            plain_ms=device_ms(torch,
                               lambda: lru.rglru_gated_scan_plain(*args)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            unfused_ms=device_ms(torch, lambda: gated_unfused(torch, lru,
                                                              *args)),
            kernel_us=kernel_us(torch,
                                lambda: lru.rglru_gated_scan(*args))))
    for r in rows:
        r["max_abs_err"] = main_err[r["name"]]
        r["x_library"] = (None if r["library_ms"] is None
                          else r["ms"] / r["library_ms"])
        r["x_bound"] = r["ms"] / r["bound_ms"]
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms ({r['x_library']:.2f}x)")
        extra = "".join(f", {k} {r[k]:.4f}" for k in OPTIONAL if k in r)
        say(f"  {r['name']:16s} {r['shape']}: kernel {r['ms']:.4f} ms "
            f"({r['kernel_us']:.3f} us its own), plain {r['plain_ms']:.4f} "
            f"ms, library {lib}, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}; {r['x_bound']:.1f}x){extra}")
    return rows


def check_moe_products(torch, dev):
    """The MoE expert products as the card computes them
    (``blocks._mm_f32``: bf16 GEMMs with fp32 outputs, an fp32 operand in
    three bf16 parts) at deepseek-v2-lite-16b's widths, for a decode
    step's 8 tokens and a 64-token prefill: gate/up (x against (E, d, f))
    and the down projection (the masked fp32 h, 6 experts of 64 live per
    token, against (E*f, d)). Each must be as exact as the product of the
    widened operands against fp64: within twice the widened product's
    largest error plus 2e-5 of the output's scale. Then both timed."""
    from repro_torch.models.blocks import _mm_f32
    E, D, F, K = 64, 2048, 1408, 6
    gen = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    w = (randn(torch, gen, (E, D, F), torch.float32) * D ** -0.5).to(bf)
    wo = (randn(torch, gen, (E * F, D), torch.float32) * F ** -0.5).to(bf)
    bad = []
    for N in (8, 64):
        x = randn(torch, gen, (N, D), bf)
        live = torch.rand((N, E), generator=gen, device=dev).argsort(-1) < K
        h = randn(torch, gen, (N, E, F), torch.float32) * live[..., None]
        for what, a, b in (("gate/up", x[None].expand(E, N, D), w),
                           ("down", h.reshape(N, E * F), wo)):
            ref = torch.matmul(a.double(), b.double())
            wide = torch.matmul(a.float(), b.float())
            got = _mm_f32(a, b)
            err_w = float((wide.double() - ref).abs().max())
            err = float((got.double() - ref).abs().max())
            ok = err <= 2 * err_w + 2e-5 * float(ref.abs().max())
            ms = device_ms(torch, lambda: _mm_f32(a, b))
            ms_w = device_ms(torch, lambda: torch.matmul(a.float(),
                                                         b.float()))
            say(f"  moe {what:7s} N{N}: max abs err vs fp64 {err:.3e} "
                f"(widened fp32 {err_w:.3e}) {'ok' if ok else 'FAIL'}; "
                f"{ms:.4f} ms (widened operands {ms_w:.4f} ms)")
            if not ok:
                bad.append(f"{what} N{N}")
    del w, wo
    if bad:
        fail("MoE expert products less exact than the widened fp32 "
             "product: " + "; ".join(bad))


def plan_note(torch, lru, B, S, W) -> str:
    """The RG-LRU kernel's grid at (B, S, W) on this card."""
    p = lru.plan(B, S, W,
                 torch.cuda.get_device_properties(0).multi_processor_count)
    return (f"{p.blocks(B, W)} blocks of {p.tile_w} lanes x {p.chunks} "
            f"chunks of {p.chunk}")


def report_registers(_build) -> None:
    """Registers, stack-frame and spill bytes of each kernel, as ptxas
    reported them when it built the library (names demangled by c++filt where the
    machine has it)."""
    for lib in _build.SOURCES:
        usage = sorted(_build.resource_usage(lib).items())
        names = [k for k, _ in usage]
        try:
            out = subprocess.run(["c++filt"], input="\n".join(names),
                                 capture_output=True, text=True, timeout=60)
            if out.returncode == 0 and len(out.stdout.splitlines()) == \
                    len(names):
                names = [n.replace("(anonymous namespace)::", "")
                         .split("(")[0].removeprefix("void ")
                         for n in out.stdout.splitlines()]
        except OSError:
            pass
        for name, (_, use) in zip(names, usage):
            say(f"  {lib}: {use.get('registers')} registers, stack "
                f"{use.get('stack')} B, spill stores {use.get('spill_stores')}"
                f" B, loads {use.get('spill_loads')} B: {name}")


# ---------------------------------------------------------------------------
# phase 3: the full-width model
# ---------------------------------------------------------------------------

def check_model(torch, dev, cfg, fp32_layers=None):
    """Full-width model, random bf16 weights from a seeded generator.

    fp32: the model run in fp32 (each bf16 weight widened where it is
    used, so no fp32 copy is held), through the kernels and through the
    plain versions, agree to FP32_REL_L2, and the prefill->decode contract
    holds at the model tests' tolerances; ``fp32_layers`` cuts the depth
    for this check. bf16: a one-ulp rounding difference anywhere grows
    through the random layers (the JAX package's own bf16 logits drift
    from its fp32 ones in the same way, further with each layer), so the
    kernels' bf16 logits are judged by their distance from the fp32 logits
    of the same depth, which may exceed the plain bf16 path's by
    BF16_VS_PLAIN at most; at BF16_CUT_LAYERS, where the drift is small,
    and at full depth. In an MoE model the rule holds the tokens that no
    routing flip between the two bf16 paths reaches (``routing_flips``);
    at full depth, where one may reach them all, the check at
    BF16_CUT_LAYERS is then the gate."""
    import numpy as np
    from repro_torch.models import build_model, tree_tensors
    gen = torch.Generator(device=dev).manual_seed(0)
    S = 64
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, S))).to(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = build_model(cfg).init(gen)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_tensors(params))
        say(f"  {cfg.name}: {n_params / 1e9:.3f} B params "
            f"({cfg.num_layers} layers, d_model {cfg.d_model}), init "
            f"{time.perf_counter() - t0:.1f} s")
        cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
        cut32, params_cut = cfg32, params
        if fp32_layers:
            cut32, params_cut = prefix(cfg32, params, fp32_layers)
        ker32 = build_model(cut32.replace(use_pallas=True))
        l32 = build_model(cut32).forward(params_cut, toks)[0]
        l32k = ker32.forward(params_cut, toks)[0]
        e32 = rel_l2(torch, l32k, l32)
        say(f"  fp32 logits {tuple(l32.shape)} at {cut32.num_layers} "
            f"layers: kernels vs plain rel-L2 {e32:.3e} (tol {FP32_REL_L2})")
        pl, cache = ker32.prefill(params_cut, toks[:, :S - 1], max_len=128)
        pos = torch.full((1,), S - 1, dtype=torch.long, device=dev)
        dl, _ = ker32.decode_step(params_cut, toks[:, S - 1:], cache, pos)
        e_pf, ok_pf = close(torch, pl[:, 0], l32k[:, S - 2], "prefill")
        e_de, ok_de = close(torch, dl[:, 0], l32k[:, S - 1], "decode")
        say(f"  fp32 prefill->decode contract through the kernels: prefill "
            f"max abs {e_pf:.3e} (tol {TOL['prefill'][1]}), decode "
            f"{e_de:.3e} (tol {TOL['decode'][1]})")
        del cache, ker32, l32, l32k, params_cut
        torch.cuda.empty_cache()
        if e32 > FP32_REL_L2 or not (ok_pf and ok_de):
            fail(f"{cfg.name}: fp32 model through the kernels disagrees "
                 "with the plain versions or breaks the prefill->decode "
                 "contract")
        depths = [prefix(cfg, params, BF16_CUT_LAYERS)]
        if depths[0][0].num_layers < cfg.num_layers:
            depths.append((cfg, params))
        for c16, p16 in depths:
            c32 = c16.replace(dtype="float32", param_dtype="float32")
            l32 = build_model(c32).forward(p16, toks)[0]
            lk, rk = routings(lambda: build_model(
                c16.replace(use_pallas=True)).forward(p16, toks)[0])
            lp, rp = routings(lambda: build_model(c16).forward(p16,
                                                               toks)[0])
            e_k, e_p = rel_l2(torch, lk, l32), rel_l2(torch, lp, l32)
            say(f"  bf16 logits vs fp32 at {c16.num_layers} layers: kernels"
                f" rel-L2 {e_k:.3e}, plain {e_p:.3e} (kernels <= "
                f"{BF16_VS_PLAIN} x plain); kernels vs plain "
                f"{rel_l2(torch, lk, lp):.3e}")
            held = "all tokens"
            if rk:
                agree, keep = routing_flips(torch, rk, rp)
                say(f"  routing at {c16.num_layers} layers: kernels and "
                    f"plain agree on {agree:.6f} of the "
                    f"{sum(r.numel() for r in rk)} (token, expert) choices; "
                    f"{int(keep.sum())} of {keep.numel()} tokens reached "
                    "by no flip")
                if not bool(keep.any()):
                    if c16.num_layers <= BF16_CUT_LAYERS:
                        fail(f"{cfg.name}: a routing flip reaches every "
                             f"token at {c16.num_layers} layers")
                    say(f"  not gated at {c16.num_layers} layers: a "
                        "routing flip reaches every token (the check at "
                        f"{BF16_CUT_LAYERS} layers is the gate)")
                    del l32, lk, lp
                    continue
                if not bool(keep.all()):
                    lk, lp, l32 = lk[keep], lp[keep], l32[keep]
                    e_k = rel_l2(torch, lk, l32)
                    e_p = rel_l2(torch, lp, l32)
                    held = f"the {int(keep.sum())} tokens no flip reaches"
                    say(f"  on {held}: kernels rel-L2 {e_k:.3e}, plain "
                        f"{e_p:.3e}")
            if not bool(torch.isfinite(lk).all()) or \
                    e_k > BF16_VS_PLAIN * e_p:
                fail(f"{cfg.name}: bf16 model logits through the kernels "
                     f"at {c16.num_layers} layers ({held}) are further from "
                     "fp32 than the plain versions'")
            del l32, lk, lp
    del params
    torch.cuda.empty_cache()


def routings(fn):
    """``fn()`` with the top-k experts of every MoE layer it runs recorded:
    (its result, a (B, S, K) tensor per MoE layer, in order)."""
    from repro_torch.models import blocks
    real, seen = blocks.moe_forward, []

    def recording(p, cfg, x):
        seen.append(blocks.route(p, cfg, x)[2])
        return real(p, cfg, x)

    blocks.moe_forward = recording
    try:
        return fn(), seen
    finally:
        blocks.moe_forward = real


def routing_flips(torch, a, b):
    """Two runs' routings (``routings``) of one sequence: the share of the
    first run's (token, expert) choices that the second also made, and the
    (B, S) tokens that no flip reaches. A token whose expert set differs
    at any MoE layer is flipped; a flip before the last layer (the MoE
    layers are a model's last) also reaches every later position of its
    row, through attention."""
    a = torch.stack([r.sort(-1).values for r in a])      # (layers, B, S, K)
    b = torch.stack([r.sort(-1).values for r in b])
    agree = float((a[..., :, None] == b[..., None, :]).any(-1).float()
                  .mean())
    diff = (a != b).any(-1)                              # (layers, B, S)
    S = diff.shape[-1]
    pos = torch.arange(S, device=a.device)
    early = diff[:-1].any(0)                              # (B, S)
    first = torch.where(early, pos, S).min(-1).values     # (B,)
    return agree, ~diff.any(0) & (pos[None] < first[:, None])


def prefix(cfg, params, layers):
    """The model cut to its first ``layers`` layers (an MoE model's dense
    prefix layers among them); a hybrid to as many whole (rec, rec, attn)
    units (at least one) and its tail."""
    if cfg.arch_type == "hybrid":
        units = max(1, layers // len(cfg.block_pattern))
        return (cfg.replace(num_layers=units * len(cfg.block_pattern)
                            + len(params["tail"])),
                dict(params, units=params["units"][:units]))
    n_prefix = len(params.get("prefix", ()))
    return (cfg.replace(num_layers=layers),
            dict(params, layers=params["layers"][:layers - n_prefix]))


# ---------------------------------------------------------------------------
# phase 4: serve under AGFT
# ---------------------------------------------------------------------------

def graphs_and_serve(torch, dev, cfg):
    """Phase 4 for one model; returns the AGFT serve run's launch counts."""
    from repro_torch.energy import H100
    from repro_torch.serving import TorchBackend
    c32 = cfg.replace(dtype="float32", param_dtype="float32",
                      num_layers=FP32_LAYERS.get(cfg.name, cfg.num_layers))
    for c in (c32, cfg):
        backend = None                    # free the last one first
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        backend = TorchBackend(c, H100, max_batch=8, cache_len=2048,
                               device=dev)
        torch.cuda.synchronize()
        graphs = backend.graphs
        say(f"  {c.name} {c.dtype} at {c.num_layers} layers: backend ready "
            f"in {time.perf_counter() - t0:.1f} s; {len(graphs)} graphs "
            f"captured in {sum(g.capture_s for g in graphs):.2f} s (warm-up "
            f"included), holding "
            f"{sum(g.memory_bytes for g in graphs) / 2**20:.1f} MiB; a "
            f"decode replay launches {backend.decode_graph.launches}")
        check_graphs(torch, dev, backend)
    from repro_torch.models import tree_tensors
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_tensors(backend.params))
    say(f"  weight floor of a step: {nbytes / 1e9:.2f} GB of weights once "
        f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
        f"{1e3 * nbytes / HBM_BYTES_PER_S:.3f} ms")
    counts = serve(torch, backend, "agft", normal_requests(),
                   sampling_period_s=0.2)
    serve(torch, backend, "static", normal_requests(), sampling_period_s=0.2)
    trace_steps(torch, backend)
    if cfg.num_experts:
        step_parts(torch, backend)
    return counts


def step_parts(torch, backend, context: int = 600):
    """Where an MoE model's decode step goes, by part: each part of one
    layer timed alone (``device_ms``) on the backend's own weights at the
    step's shapes (``max_batch`` tokens; under MLA a cache of
    ``cache_len`` slots at ``context``), times the layers that run it. The
    layer's weights meet the part cold, as in a step; the latent cache
    (16.8 MB a layer) stays in L2 between calls, as it does not in a
    step."""
    from repro_torch.models import attention as attn
    from repro_torch.models import blocks
    from repro_torch.models.common import model_rope
    cfg, params, dev = backend.cfg, backend.params, backend.device
    B, T, D = backend.max_batch, backend.cache_len, cfg.d_model
    E, F = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(3)
    dt = cfg.activation_dtype
    lp = params["layers"][0]
    moe, n_moe = lp["moe"], len(params["layers"])
    h = randn(torch, gen, (B, 1, D), dt)
    xe = h.reshape(B, D)[None].expand(E, B, D)
    hf = randn(torch, gen, (B, E * F), torch.float32)
    w_out = moe["w_out"].reshape(E * F, D)
    parts = [("MoE block", n_moe, lambda: blocks.moe_forward(moe, cfg, h)),
             ("  its expert products (gate, up, down)", n_moe,
              lambda: (blocks._mm_f32(xe, moe["w_gate"]),
                       blocks._mm_f32(xe, moe["w_in"]),
                       blocks._mm_f32(hf, w_out)))]
    if cfg.use_mla:
        pos = torch.full((B,), context, dtype=torch.long, device=dev)
        cache = attn.MLACache(
            randn(torch, gen, (B, T, cfg.kv_lora_rank), dt),
            randn(torch, gen, (B, T, cfg.qk_rope_head_dim), dt))
        slots = attn.decode_slots(cfg, T, pos)
        rope = model_rope(cfg, pos[:, None])
        k_nope, v = attn._mla_up(lp["attn"], cfg, cache.c_kv)
        parts += [
            ("MLA decode", cfg.num_layers,
             lambda: attn.mla_decode(lp["attn"], cfg, h, cache, slots, rope)),
            ("  its up-projection of the cache (K, V)", cfg.num_layers,
             lambda: attn._mla_up(lp["attn"], cfg, cache.c_kv)),
            ("  its fp32 casts of K and V", cfg.num_layers,
             lambda: (k_nope.float(), v.float()))]
    say(f"  {cfg.name} decode step by part (batch {B}, one layer's part "
        "timed alone, x layers):")
    with torch.no_grad():
        for name, n, fn in parts:
            ms = device_ms(torch, fn)
            say(f"    {name}: {ms:.4f} ms x {n} = {n * ms:.3f} ms")


def check_graphs(torch, dev, backend, steps: int = 3):
    """Each graph of the backend against the eager step it captured, bit for
    bit: ``steps`` decode steps of random tokens from a random cache (the
    graph on the backend's cache, the eager step on a clone of it), and
    every prefill bucket's forward. recurrentgemma-9b's rows cross its
    2048-slot ring. The cache and the token are zeroed again after."""
    from repro_torch.models import tree_clone, tree_tensors
    cfg, B = backend.cfg, backend.max_batch
    gen = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        for t in tree_tensors(backend.cache):
            t.normal_(generator=gen)
        eager_cache = tree_clone(backend.cache)
        start = ([600, 1, 37, 2045, 2046, 2047, 3000, 4094]
                 if cfg.arch_type == "hybrid"
                 else [600, 1, 37, 255, 1024, 1500, 2000, 2040])[:B]
        bad = []
        for step in range(steps):
            pos = torch.tensor([p + step for p in start], device=dev)
            backend.pos.copy_(pos)
            backend.token.random_(0, cfg.vocab_size, generator=gen)
            got = backend.decode_graph()
            want = backend.model.decode_step(backend.params, backend.token,
                                             eager_cache, pos)[0]
            same = [torch.equal(a, b) for a, b in
                    zip(tree_tensors(backend.cache),
                        tree_tensors(eager_cache))]
            if not (torch.equal(got, want) and all(same)):
                bad.append(f"decode step {step}: logits "
                           f"{torch.equal(got, want)}, cache tensors equal "
                           f"{sum(same)}/{len(same)}")
        for n, graph in backend.prefill_graphs.items():
            toks = torch.zeros((1, n), dtype=torch.long, device=dev)
            if not torch.equal(graph(),
                               backend.model.forward(backend.params, toks)[0]):
                bad.append(f"prefill bucket {n}")
        for t in tree_tensors(backend.cache):
            t.zero_()
        backend.token.zero_()
        torch.cuda.synchronize()
    say(f"  graphs vs eager, bit for bit: {steps} decode steps from rows at "
        f"{start}, logits and {len(same)} cache tensors; prefill buckets "
        f"{list(backend.prefill_graphs)}: {'ok' if not bad else bad}")
    if bad:
        fail(f"{cfg.name} {cfg.dtype}: a CUDA graph's replay differs from "
             "the eager step: " + "; ".join(bad))


def normal_requests():
    """Phase 4's 8 ``normal`` requests, outputs cut to 64 tokens."""
    from repro_torch.workloads import PROTOTYPES, generate_requests
    reqs = generate_requests(PROTOTYPES["normal"], 8, seed=0)
    for r in reqs:
        r.output_len = min(r.output_len, 64)
    return reqs


def serve(torch, backend, policy_name, reqs, **policy_kw):
    """``reqs`` through ``InferenceEngine`` on ``backend`` under a
    registered policy (``static``: pinned at f_max), from a zeroed cache,
    with the checks of the path: every request finishes at its own length,
    the policy decides (AGFT for a round at least; a phased policy leaves
    the engine in phased mode, every ``agft-2d`` decision a pair), and each
    kernel launches as ``path_launches`` says; returns the launch counts."""
    from repro_torch.energy import H100
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import summarize
    from repro_torch.models import tree_tensors
    from repro_torch.policies import get_policy
    from repro_torch.serving import EngineConfig, InferenceEngine
    cfg = backend.cfg
    eng = InferenceEngine(cfg, EngineConfig(max_num_seqs=8), hardware=H100,
                          backend=backend)
    if policy_name == "static":
        policy_kw["frequency_mhz"] = H100.f_max
    tuner = get_policy(policy_name, H100, **policy_kw)
    eng.submit(reqs)
    for t in tree_tensors(backend.cache):
        t.zero_()
    fwd0, dec0 = backend.prefill_steps, backend.decode_steps
    walls0 = len(backend.decode_wall_s)
    torch.cuda.synchronize()
    reset_launch_counts()                 # count the main path alone
    t0 = time.perf_counter()
    eng.drain(policy=tuner)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    c = eng.metrics.c
    lengths = backend.prefill_lengths[fwd0:]
    dec = backend.decode_steps - dec0
    walls = backend.decode_wall_s[walls0:]
    step_ms = 1e3 * statistics.median(walls) if walls else float("nan")
    say(f"  {cfg.name} under {policy_name} (window "
        f"{tuner.monitor.sampling_period_s} s): {c.iterations_total} "
        f"iterations ({len(lengths)} prefill forwards, {dec} decode steps) "
        f"in {wall:.2f} s wall, {eng.clock:.3f} s on the engine's clock; "
        f"median decode step {step_ms:.3f} ms (graph)")
    tokens = c.generation_tokens_total
    e_tok = c.energy_joules_total / max(tokens, 1)
    edp = c.energy_joules_total * c.busy_seconds_total / max(tokens, 1)
    say(f"  finished {len(eng.finished)}/{len(reqs)}, energy "
        f"{c.energy_joules_total:.3f} J (DVFS model), {tokens} tokens: "
        f"{e_tok:.6f} J/token, EDP {edp:.6f} J s (energy x busy s / token);"
        f" policy decisions {len(tuner.history)}")
    say(f"  summary (launch.serve.summarize): "
        f"{json.dumps(summarize(eng, tuner))}")
    say(f"  frequency history (MHz): "
        f"{[h['freq'] for h in tuner.history]}")
    phased = getattr(tuner, "phased", False)
    if phased:
        say(f"  engine.freq_targets (f_prefill, f_decode): "
            f"{eng.freq_targets}")
    say(f"  kernel launches on the serve path: {counts}")
    say(f"  prefill lengths (bucket: forwards): "
        f"{ {n: lengths.count(n) for n in sorted(set(lengths))} }")
    checks = {
        f"all {len(reqs)} requests finished": len(eng.finished) == len(reqs),
        "generated == output_len": all(r.generated == r.output_len
                                       for r in eng.finished),
        "energy > 0": c.energy_joules_total > 0,
        "the policy decided": len(tuner.history) >= 1,
    }
    if policy_name == "agft":
        checks["tuner.round >= 1"] = tuner.round >= 1
    if phased:
        checks["engine in phased mode (freq_targets a pair)"] = \
            isinstance(eng.freq_targets, tuple) and \
            len(eng.freq_targets) == 2
    if policy_name == "agft-2d":
        checks["every decision a (f_prefill, f_decode) pair"] = all(
            isinstance(h["freq"], tuple) and len(h["freq"]) == 2
            for h in tuner.history)
    want = path_launches(cfg, lengths, dec)
    for name, n in counts.items():
        checks[f"{name} launches == {want.get(name, 0)}"] = \
            n == want.get(name, 0)
    checks["every kernel of the path launched"] = all(
        counts[name] > 0 for name in want)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"{cfg.name} serve under {policy_name}: " + "; ".join(bad))
    return counts


def path_launches(cfg, prefill_lengths, dec):
    """The launches each kernel of the model's path makes over the serve
    phase, from the forwards and decode steps it ran: per forward and per
    decode step, RMSNorm 2L+1 (dense, hybrid) or L+1 (Mamba-2: its gated
    norm stays plain, as in the JAX package), of which all but the first
    (after the embedding) take the residual add in (``rmsnorm_fused``);
    per forward, flash attention
    L (dense) and the SSD scan L (Mamba-2, at every length); per decode
    step, decode attention L (dense) or once per attention layer (hybrid),
    neither under MLA (an MoE model's norms are the dense model's: 2L+1,
    its latents' norm staying plain, as in the JAX package);
    per forward and per decode step, the RG-LRU kernel's fused form once per
    rec layer (hybrid), counted in ``rglru_scan`` and, by its length, in
    ``rglru_gated`` (two tokens or more) or ``rglru_gated_step`` (one: a
    decode step, or a one-token forward). Kernels absent here must not
    launch."""
    L = cfg.num_layers
    fwd = len(prefill_lengths)
    if cfg.arch_type == "ssm":
        return {"rmsnorm": (L + 1) * (fwd + dec),
                "rmsnorm_fused": L * (fwd + dec), "ssd_scan": L * fwd}
    norms = {"rmsnorm": (2 * L + 1) * (fwd + dec),
             "rmsnorm_fused": 2 * L * (fwd + dec)}
    if cfg.arch_type == "hybrid":
        pat = cfg.block_pattern
        units, tail = L // len(pat), L % len(pat)
        rec = units * pat.count("rec") + tail
        multi = sum(n >= 2 for n in prefill_lengths)
        return {**norms, "rglru_scan": rec * (fwd + dec),
                "rglru_gated": rec * multi,
                "rglru_gated_step": rec * (fwd - multi + dec),
                "decode_attention": units * pat.count("attn") * dec}
    if cfg.use_mla:                   # MLA attends by einsum, as in JAX
        return norms
    return {**norms, "flash_attention": L * fwd, "decode_attention": L * dec}


def trace_steps(torch, backend, steps: int = 4, timed: int = 20):
    """Where a decode step's time goes, and the largest prefill bucket's,
    each run eagerly and as the backend's graph, on the serve phase's model
    and cache (the decode step at context 600; launches here are not
    counted into the serve path's): the median wall time of ``timed``
    calls each ended by a synchronize, then ``torch.profiler`` over
    ``steps`` calls (``traced``: the trace must hold every port kernel
    that the launch counts say ran, a graph's as its capture recorded),
    with the device-busy share of the traced wall time, the kernels a
    call, and the top device kernels and host ops."""
    from torch.autograd import DeviceType
    B, n = backend.max_batch, max(backend.prefill_graphs)
    backend.pos.fill_(600)
    toks = torch.zeros((1, n), dtype=torch.long, device=backend.device)
    decode = f"decode step (context 600, batch {B})"
    prefill = f"forward ({n} tokens)"
    forms = {
        f"eager {decode}": lambda: backend.model.decode_step(
            backend.params, backend.token, backend.cache, backend.pos),
        f"graph {decode}": backend.decode_graph,
        f"eager {prefill}": lambda: backend.model.forward(backend.params,
                                                          toks),
        f"graph {prefill}": backend.prefill_graphs[n]}
    with torch.no_grad():
        for label, step in forms.items():
            step()
            torch.cuda.synchronize()
            walls = []
            for _ in range(timed):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            events, wall = traced(torch, step, steps, cpu=True)
            # CPU ops also carry their kernels' device time: count the
            # device-side kernel events alone (not the span of the
            # profiler's step, which is a device-side event too)
            kernels = [e for e in events if e.device_type != DeviceType.CPU
                       and not e.key.startswith("ProfilerStep")]
            busy = sum(e.self_device_time_total for e in kernels) / steps / 1e3
            say(f"  {label}: median {1e3 * statistics.median(walls):.3f} ms "
                f"of {timed}; traced wall {1e3 * wall:.3f} ms, device busy "
                f"{busy:.3f} ms ({100 * busy / (1e3 * wall):.1f}%), "
                f"{sum(e.count for e in kernels) // steps} kernels")
            say(f"  {label}: top device kernels per call (ms, launches):")
            for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                            reverse=True)[:6]:
                say(f"    {e.self_device_time_total / steps / 1e3:8.4f}  "
                    f"{e.count // steps:5d}  {e.key[:90]}")
            say(f"  {label}: the port's kernels per call (ms, launches; "
                "all that the counts say ran):")
            for e in sorted(port_events(events), key=lambda e: e.key):
                say(f"    {e.self_device_time_total / steps / 1e3:8.4f}  "
                    f"{e.count // steps:5d}  {e.key[:90]}")
            say(f"  {label}: top host ops per call (self cpu ms, calls):")
            for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                            reverse=True)[:4]:
                say(f"    {e.self_cpu_time_total / steps / 1e3:8.4f}  "
                    f"{e.count // steps:5d}  {e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 5: the paper's workload
# ---------------------------------------------------------------------------

def azure_trace():
    from repro_torch.workloads import generate_azure_trace
    return generate_azure_trace(AZURE["duration_s"],
                                base_rate=AZURE["base_rate"],
                                year=AZURE["year"], seed=AZURE["seed"])


def serve_azure(torch, dev):
    """Phase 5: the Azure trace under each of ``AZURE_POLICIES`` on one
    bf16 backend of full-width llama3-3b; returns the runs' launch counts,
    summed."""
    from repro_torch.energy import H100
    from repro_torch.serving import TorchBackend
    t0 = time.perf_counter()
    reqs = azure_trace()
    prompts = [r.prompt_len for r in reqs]
    outs = [r.output_len for r in reqs]
    say(f"  trace: generate_azure_trace({AZURE['duration_s']}, base_rate="
        f"{AZURE['base_rate']}, year={AZURE['year']}, seed={AZURE['seed']})"
        f": {len(reqs)} requests, prompt length median "
        f"{statistics.median(prompts)}, max {max(prompts)}, "
        f"{sum(prompts)} in all; output length {min(outs)}-{max(outs)}, "
        f"{sum(outs)} in all")
    cfg = model_config("llama3-3b")
    backend = TorchBackend(cfg, H100, max_batch=8, cache_len=2048,
                           device=dev)
    torch.cuda.synchronize()
    say(f"  {cfg.name} {cfg.dtype} at {cfg.num_layers} layers: backend "
        f"ready in {time.perf_counter() - t0:.1f} s")
    total = {}
    for name in AZURE_POLICIES:    # each at the registry's window
        for k, n in serve(torch, backend, name, azure_trace()).items():
            total[k] = total.get(k, 0) + n
    say(f"  phase 5: {time.perf_counter() - t0:.1f} s wall, backend "
        f"included; launches of the four runs: {total}")
    return total


# ---------------------------------------------------------------------------

def model_config(name):
    """The model's config at full width, at the depth one card holds."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return cfg.replace(num_layers=DEPTH.get(name, cfg.num_layers))


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a "
             "checkout of the repo")
    sys.path.insert(0, SRC)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    say("== phase 1: environment")
    card = card_line()
    say(f"  card: {card}")
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    say(f"  build: nvcc {time.perf_counter() - t0:.1f} s (all "
        f"{len(_build.SOURCES)} CUDA sources at once)")
    report_registers(_build)

    say("== phase 2: kernels vs plain versions")
    main_err = check_kernels(torch, dev)
    rows = time_kernels(torch, dev, main_err)
    check_moe_products(torch, dev)

    say("== phase 3: full-width models")
    for name in MODELS:
        check_model(torch, dev, model_config(name),
                    fp32_layers=FP32_LAYERS.get(name))

    say("== phase 4: CUDA graphs, and serve under AGFT and static")
    counts = {}                           # model -> kernel -> launches
    for name in MODELS:
        counts[name] = graphs_and_serve(torch, dev, model_config(name))
        torch.cuda.empty_cache()

    say("== phase 5: the Azure 2024 trace, llama3-3b under agft, agft-2d, "
        "greenllm-rule and static")
    counts[AZURE_RUN] = serve_azure(torch, dev)
    torch.cuda.empty_cache()

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "x_library", "x_bound", "kernel_us", "launches_by_model",
            "shape")
    for r in rows:
        kernel, models = ROWS[r["name"]]
        r["launches_by_model"] = {m: counts[m][kernel] for m in models}
        r["launches"] = sum(r["launches_by_model"].values())
    for kernel in counts[MODELS[0]]:     # each serve launch is in one row
        if sum(counts[m][kernel] for m in counts) != sum(
                r["launches"] for r in rows if ROWS[r["name"]][0] == kernel):
            fail(f"{kernel}: serve launches missing from the kernels line")
    say(f"card: {card}")
    say(json.dumps({"kernels": [
        {k: r[k] for k in keys + OPTIONAL if k in r} for r in rows]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
