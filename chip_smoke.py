#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It imports the port only (never JAX or
the JAX package ``repro``), needs one CUDA card, and exits non-zero on any
failure, or when there is no card or no checkout beside it. Phases:

1. Environment: the card's name and power limit, and the kernel build
   (one ``nvcc`` per CUDA source, all at once, plus the Triton compile).
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, on the sweep shapes of ``tests/test_kernels.py`` and on the
   serving paths' shapes, at 2e-5 (fp32) and 2e-2 (bf16) elementwise, bf16
   also at BF16_REL_L2 over the whole output, the SSD scan at 2e-4 and the
   RG-LRU scan at 1e-5; then each timed with CUDA events beside its plain
   version and, where one exists, one PyTorch library call.
3. Models: full-width llama3-3b, mamba2-1.3b and recurrentgemma-9b from a
   seeded generator, one at a time; fp32 logits through the kernels
   against the plain versions (recurrentgemma-9b cut to 5 layers: a unit
   and the tail), the prefill->decode contract, and bf16 judged against
   fp32, at 2 layers (a hybrid: 5) and at full depth.
4. Serve: ``InferenceEngine`` + ``TorchBackend`` + the AGFT tuner over 8
   ``normal`` requests for each of the three models, the launch counts set
   to 0 before each and read after it; each kernel of a model's path must
   have run there, as many times as the path says.

The last lines are a JSON object with each kernel's numbers (a row per
kernel and timed shape; its launches are those of the serve runs whose
path runs that shape, also given per model) and the result line
``{"ok": true, "device": {...}}``.
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
SWEEP_DECODE = [(1, 512, 4, 4, 64), (2, 1024, 8, 2, 64), (4, 512, 4, 1, 128)]
MAIN_DECODE = (8, 2048, 24, 8, 128)
SWEEP_RMS = [(4, 128), (2, 17, 256), (3, 5, 7, 512)]
MAIN_RMS = [(8, 3072), (64, 3072)]
# recurrentgemma-9b's decode: 16 query heads over 1 kv head at head_dim
# 256, against the 2048-slot ring of its local attention
WIDE_DECODE = (8, 2048, 16, 1, 256)
# (b, s, h, p, g, n, chunk): the test_ssd_sweep shapes; mamba2-1.3b's
# prefill buckets of 1, 2 and 64 tokens (chunk = s); and 256 (chunk 128)
SWEEP_SSD = [(1, 128, 4, 64, 1, 64, 32), (2, 256, 8, 32, 2, 32, 64),
             (1, 64, 2, 64, 1, 128, 16), (1, 256, 64, 64, 1, 128, 128)]
MAIN_SSD = [(1, s, 64, 64, 1, 128, s) for s in (1, 2, 64)]
# (B, S, W): the test_rglru_sweep shapes; recurrentgemma-9b's width
SWEEP_RGLRU = [(1, 64, 128), (2, 256, 256), (3, 128, 384)]
MAIN_RGLRU = [(1, 64, 4096), (1, 256, 4096)]
MODELS = ("llama3-3b", "mamba2-1.3b", "recurrentgemma-9b")
# recurrentgemma-9b's fp32 kernels-vs-plain check covers one (rec, rec,
# attn) unit and the two-layer tail, 5 layers; its bf16 check runs all 38
HYBRID_FP32_LAYERS = 5
# the shallow bf16 check: 2 layers (a hybrid: a unit and its tail), where
# a rounding flip has not yet grown through the depth
BF16_CUT_LAYERS = 2
# each timed row of the kernels line: its kernel, and the serve runs whose
# path launches that kernel at the row's shape (the row counts theirs)
ROWS = {"rmsnorm": ("rmsnorm", MODELS),
        "flash_attention": ("flash_attention", ("llama3-3b",)),
        "decode_attention": ("decode_attention", ("llama3-3b",)),
        "decode_attention_d256_g16": ("decode_attention",
                                      ("recurrentgemma-9b",)),
        "ssd_scan": ("ssd_scan", ("mamba2-1.3b",)),
        "rglru_scan": ("rglru_scan", ("recurrentgemma-9b",))}


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
        for shape in SWEEP_RMS + MAIN_RMS:
            x = randn(torch, gen, shape, dt)
            w = (1.0 + 0.1 * randn(torch, gen, (shape[-1],),
                                   torch.float32)).to(dt)
            record("rmsnorm", str(shape), dn, rms.rmsnorm(x, w),
                   rms.rmsnorm_plain(x, w), shape in MAIN_RMS)
        for (B, S, H, Hkv, D) in SWEEP_FLASH + MAIN_FLASH:
            q = randn(torch, gen, (B, S, H, D), dt)
            k = randn(torch, gen, (B, S, Hkv, D), dt)
            v = randn(torch, gen, (B, S, Hkv, D), dt)
            record("flash_attention", f"B{B} S{S} H{H} Hkv{Hkv} D{D}", dn,
                   fa.flash_attention(q, k, v, causal=True),
                   fa.flash_attention_plain(q, k, v, causal=True),
                   (B, S, H, Hkv, D) in MAIN_FLASH)
        for (B, T, H, Hkv, D) in SWEEP_DECODE + [MAIN_DECODE]:
            lengths = torch.randint(1, T + 1, (B,), generator=gen,
                                    device=dev)
            valid = torch.arange(T, device=dev)[None] < lengths[:, None]
            decode_case(B, T, H, Hkv, D, dt, dn, valid,
                        (B, T, H, Hkv, D) == MAIN_DECODE)
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
        record("ssd_scan", case + " y", "float32", y, y_r, main, "ssd")
        record("ssd_scan", case + " state", "float32", st, st_r, main,
               "ssd")
    for (B, S, W) in SWEEP_RGLRU + MAIN_RGLRU:
        args = rglru_inputs(torch, gen, B, S, W)
        ys, hl = lru.rglru_scan(*args)
        ys_r, hl_r = lru.rglru_scan_plain(*args)
        main = (B, S, W) in MAIN_RGLRU
        record("rglru_scan", f"B{B} S{S} W{W} ys", "float32", ys, ys_r,
               main, "rglru")
        record("rglru_scan", f"B{B} S{S} W{W} h_last", "float32", hl, hl_r,
               main, "rglru")
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

    # rmsnorm at the decode step's shape: 8 rows of 3072
    R, D = MAIN_RMS[0]
    x = randn(torch, gen, (R, D), bf)
    w = (1.0 + 0.1 * randn(torch, gen, (D,), torch.float32)).to(bf)
    nbytes = 2 * R * D * 2 + D * 2
    b_ms, b_by = bound_ms(nbytes, 4.0 * R * D, "float32")
    rows.append(dict(
        name="rmsnorm", route="triton",
        source="src/repro_torch/kernels/rmsnorm.py",
        replaces="src/repro/kernels/rmsnorm.py:23",
        shape=f"x ({R}, {D}) bf16",
        ms=device_ms(torch, lambda: rms.rmsnorm(x, w)),
        plain_ms=device_ms(torch, lambda: rms.rmsnorm_plain(x, w)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms(lambda: F.rms_norm(x, (D,), w, 1e-6),
                          "rmsnorm")))
    # flash prefill at the largest prefill bucket
    B, S, H, Hkv, Dh = MAIN_FLASH[-1]
    q = randn(torch, gen, (B, S, H, Dh), bf)
    k = randn(torch, gen, (B, S, Hkv, Dh), bf)
    v = randn(torch, gen, (B, S, Hkv, Dh), bf)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    nbytes = 2 * (2 * B * S * H * Dh + 2 * B * S * Hkv * Dh)
    flops = 4.0 * B * H * Dh * S * (S + 1) / 2
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:65",
        shape=f"q ({B}, {S}, {H}, {Dh}), kv heads {Hkv}, causal, bf16",
        ms=device_ms(torch, lambda: fa.flash_attention(q, k, v)),
        plain_ms=device_ms(torch, lambda: fa.flash_attention_plain(q, k, v)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), "flash")))
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
                qt, kt, vt, attn_mask=mask, enable_gqa=True), "decode"))

    # decode at llama3-3b's cache shape, and at recurrentgemma-9b's
    # (16 query heads over 1 kv head at head_dim 256, a 2048-slot ring)
    for row, shape, max_len in (
            ("decode_attention", MAIN_DECODE, MAIN_DECODE[1]),
            ("decode_attention_d256_g16", WIDE_DECODE,
             2 * WIDE_DECODE[1] - 1)):
        rows.append(dict(
            name=row, route="cuda",
            source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:57",
            **decode_timing(shape, max_len)))
    # SSD at mamba2-1.3b's largest prefill bucket (64 tokens, chunk 64).
    # The bound counts the products the function needs, in fp32 (no tensor
    # core): C.B^T on the causal half once per (batch, group, chunk), as
    # the heads of a group share it; per head att.x on the causal half,
    # the state update, and C.S_prev for every chunk but the first, whose
    # incoming state is 0
    b, s, h, p, g, n, c = MAIN_SSD[-1]
    args = ssd_inputs(torch, gen, b, s, h, p, g, n, mamba2_decay=True)
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n
                  + b * h * p * n)
    tri = s // c * c * (c + 1) / 2
    flops = 2.0 * b * (g * tri * n
                       + h * (tri * p + s * p * n + (s - c) * p * n))
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    say("  library call for ssd_scan: none (no single PyTorch call "
        "computes the chunked SSD scan)")
    rows.append(dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd.py:66",
        shape=f"x ({b}, {s}, {h}, {p}), B/C ({b}, {s}, {g}, {n}), "
              f"chunk {c}, fp32",
        ms=device_ms(torch, lambda: ssd.ssd_scan(*args, chunk=c)),
        plain_ms=device_ms(torch, lambda: ssd.ssd_scan_plain(*args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
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
        shape=f"x, log_a ({B}, {S}, {W}), fp32",
        ms=device_ms(torch, lambda: lru.rglru_scan(*args)),
        plain_ms=device_ms(torch, lambda: lru.rglru_scan_plain(*args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for r in rows:
        r["max_abs_err"] = main_err[r["name"]]
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        say(f"  {r['name']:16s} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {lib} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return rows


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
    and at full depth."""
    import numpy as np
    from repro_torch.models import build_model
    gen = torch.Generator(device=dev).manual_seed(0)
    S = 64
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, S))).to(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = build_model(cfg).init(gen)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
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
        for c16, p16 in (prefix(cfg, params, BF16_CUT_LAYERS),
                         (cfg, params)):
            c32 = c16.replace(dtype="float32", param_dtype="float32")
            l32 = build_model(c32).forward(p16, toks)[0]
            lk = build_model(c16.replace(use_pallas=True)).forward(p16,
                                                                   toks)[0]
            lp = build_model(c16).forward(p16, toks)[0]
            e_k, e_p = rel_l2(torch, lk, l32), rel_l2(torch, lp, l32)
            say(f"  bf16 logits vs fp32 at {c16.num_layers} layers: kernels"
                f" rel-L2 {e_k:.3e}, plain {e_p:.3e} (kernels <= "
                f"{BF16_VS_PLAIN} x plain); kernels vs plain "
                f"{rel_l2(torch, lk, lp):.3e}")
            if not bool(torch.isfinite(lk).all()) or \
                    e_k > BF16_VS_PLAIN * e_p:
                fail(f"{cfg.name}: bf16 model logits through the kernels "
                     f"at {c16.num_layers} layers are further from fp32 "
                     "than the plain versions'")
            del l32, lk, lp
    del params
    torch.cuda.empty_cache()


def prefix(cfg, params, layers):
    """The model cut to its first ``layers`` layers; a hybrid to as many
    whole (rec, rec, attn) units (at least one) and its tail."""
    if cfg.arch_type == "hybrid":
        units = max(1, layers // len(cfg.block_pattern))
        return (cfg.replace(num_layers=units * len(cfg.block_pattern)
                            + len(params["tail"])),
                dict(params, units=params["units"][:units]))
    return (cfg.replace(num_layers=layers),
            dict(params, layers=params["layers"][:layers]))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 4: serve under AGFT
# ---------------------------------------------------------------------------

def serve(torch, dev, cfg):
    from repro_torch.energy import H100
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.policies import get_policy
    from repro_torch.serving import EngineConfig, InferenceEngine, \
        TorchBackend
    from repro_torch.workloads import PROTOTYPES, generate_requests
    t0 = time.perf_counter()
    backend = TorchBackend(cfg, H100, max_batch=8, cache_len=2048,
                           device=dev)
    eng = InferenceEngine(cfg, EngineConfig(max_num_seqs=8), hardware=H100,
                          backend=backend)
    tuner = get_policy("agft", H100, sampling_period_s=0.2)
    reqs = generate_requests(PROTOTYPES["normal"], 8, seed=0)
    for r in reqs:
        r.output_len = min(r.output_len, 64)
    eng.submit(reqs)
    torch.cuda.synchronize()
    say(f"  backend ready in {time.perf_counter() - t0:.1f} s")
    reset_launch_counts()                 # count the main path alone
    t0 = time.perf_counter()
    eng.drain(policy=tuner)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    c = eng.metrics.c
    step_ms = (1e3 * statistics.median(backend.decode_wall_s)
               if backend.decode_wall_s else float("nan"))
    say(f"  {c.iterations_total} iterations ({backend.prefill_steps} "
        f"prefill forwards, {backend.decode_steps} decode steps) in "
        f"{wall:.2f} s wall; median decode step {step_ms:.3f} ms")
    say(f"  finished {len(eng.finished)}/8, energy {c.energy_joules_total:.3f}"
        f" J (DVFS model), tuner rounds {tuner.round}")
    say(f"  frequency history (MHz): "
        f"{[h['freq'] for h in tuner.history]}")
    say(f"  kernel launches on the serve path: {counts}")
    say(f"  prefill lengths: {backend.prefill_lengths}")
    checks = {
        "all 8 requests finished": len(eng.finished) == 8,
        "generated == output_len": all(r.generated == r.output_len
                                       for r in eng.finished),
        "energy > 0": c.energy_joules_total > 0,
        "tuner.round >= 1": tuner.round >= 1,
    }
    want = path_launches(cfg, backend)
    for name, n in counts.items():
        checks[f"{name} launches == {want.get(name, 0)}"] = \
            n == want.get(name, 0)
    checks["every kernel of the path launched"] = all(
        counts[name] > 0 for name in want)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"{cfg.name} serve phase: " + "; ".join(bad))
    trace_decode(torch, dev, backend)
    return counts


def path_launches(cfg, backend):
    """The launches each kernel of the model's path makes over the serve
    phase, from the forwards and decode steps it ran: per forward and per
    decode step, RMSNorm 2L+1 (dense, hybrid) or L+1 (Mamba-2: its gated
    norm stays plain, as in the JAX package); per forward, flash attention
    L (dense), the SSD scan L (Mamba-2, at every length) and the RG-LRU
    scan once per rec layer (hybrid, at lengths of 2 and more: a one-token
    forward takes the inline step); per decode step, decode attention L
    (dense) or once per attention layer (hybrid). Kernels absent here must
    not launch."""
    L = cfg.num_layers
    fwd, dec = backend.prefill_steps, backend.decode_steps
    if cfg.arch_type == "ssm":
        return {"rmsnorm": (L + 1) * (fwd + dec), "ssd_scan": L * fwd}
    if cfg.arch_type == "hybrid":
        pat = cfg.block_pattern
        units, tail = L // len(pat), L % len(pat)
        rec = units * pat.count("rec") + tail
        multi = sum(n >= 2 for n in backend.prefill_lengths)
        return {"rmsnorm": (2 * L + 1) * (fwd + dec),
                "rglru_scan": rec * multi,
                "decode_attention": units * pat.count("attn") * dec}
    return {"rmsnorm": (2 * L + 1) * (fwd + dec),
            "flash_attention": L * fwd, "decode_attention": L * dec}


def trace_decode(torch, dev, backend, steps: int = 4):
    """Where a decode step's time goes: ``torch.profiler`` over a few steps
    of the serve phase's model and cache (launches here are not counted
    into the serve path's). Prints the device-busy share of the traced
    wall time and the top device kernels and host ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B = backend.max_batch
    tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
    pos = torch.full((B,), 600, dtype=torch.long, device=dev)
    step = lambda: backend.model.decode_step(  # noqa: E731
        backend.params, tok, backend.cache, pos)
    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
    # CPU ops also carry their kernels' device time: count the device-side
    # kernel events alone
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type != DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    say(f"  traced decode step (context 600, batch {B}): wall "
        f"{1e3 * wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / (1e3 * wall):.1f}%), "
        f"{sum(e.count for e in kernels) // steps} kernels")
    say("  top device kernels per step (ms, launches):")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        say(f"    {e.self_device_time_total / steps / 1e3:8.4f}  "
            f"{e.count // steps:5d}  {e.key[:90]}")
    say("  top host ops per step (self cpu ms, calls):")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        say(f"    {e.self_cpu_time_total / steps / 1e3:8.4f}  "
            f"{e.count // steps:5d}  {e.key[:90]}")


# ---------------------------------------------------------------------------

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
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rms
    t0 = time.perf_counter()
    _build.build_all()
    t_nvcc = time.perf_counter() - t0
    x = torch.ones((1, 3072), dtype=torch.bfloat16, device=dev)
    rms.rmsnorm(x, x[0])
    torch.cuda.synchronize()
    say(f"  build: nvcc {t_nvcc:.1f} s (every CUDA source at once), "
        f"Triton rmsnorm compile {time.perf_counter() - t0 - t_nvcc:.1f} s")

    say("== phase 2: kernels vs plain versions")
    main_err = check_kernels(torch, dev)
    rows = time_kernels(torch, dev, main_err)

    say("== phase 3: full-width models")
    for name in MODELS:
        cfg = get_config(name)
        check_model(torch, dev, cfg, fp32_layers=(
            HYBRID_FP32_LAYERS if cfg.arch_type == "hybrid" else None))

    say("== phase 4: serve under AGFT")
    counts = {}                           # model -> kernel -> launches
    for name in MODELS:
        counts[name] = serve(torch, dev, get_config(name))
        torch.cuda.empty_cache()

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_model", "shape")
    for r in rows:
        kernel, models = ROWS[r["name"]]
        r["launches_by_model"] = {m: counts[m][kernel] for m in models}
        r["launches"] = sum(r["launches_by_model"].values())
    for kernel in counts[MODELS[0]]:     # each serve launch is in one row
        if sum(counts[m][kernel] for m in MODELS) != sum(
                r["launches"] for r in rows if ROWS[r["name"]][0] == kernel):
            fail(f"{kernel}: serve launches missing from the kernels line")
    say(f"card: {card}")
    say(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
