#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It imports the port only (never JAX or
the JAX package ``repro``), needs one CUDA card, and exits non-zero on any
failure, or when there is no card or no checkout beside it. Phases:

1. Environment: the card's name and power limit, the kernel build (one
   ``nvcc`` per CUDA source, all six at once), and each kernel's
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
   fp32 product, and timed beside it. Flash and decode attention also at
   whisper-medium's decoder shapes (16 query heads over 16 kv heads of 64,
   G = 1; decode against its 448-slot cache), checked and timed last. MLA
   decode in the latent space (``kernels.mla_decode``, which replaces no
   Pallas kernel) at deepseek-v2-lite-16b's batch of 32 over 2048 and 512
   slots, at its two mixes' contexts, timed beside SDPA over the latents
   as one kv head.
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
6. whisper-medium, the encoder-decoder, at full width and depth (24
   encoder + 24 decoder layers, 811,112,448 params, bf16 from a seeded
   generator) through its model contract (``TorchBackend`` serves
   decoder-only models, as ``JaxBackend`` does): 8 x 1500 random frames, a
   4-token prompt, a 448-slot self cache. fp32 logits through the kernels
   against the plain versions and the prefill->decode contract at 4 + 4
   layers; bf16 at full depth judged against fp32 as in phase 3. Then the
   prefill and 64 greedy decode steps, each a replay of the step captured
   as a ``StepGraph``, the launch counts set to 0 before: flash attention
   once a decoder layer at the prefill, decode attention once a layer a
   step, nothing else; the first three replays bit-equal to the eager step,
   the cross cache unchanged. encode, the prefill and the graphed step
   timed (median, p90) beside the step's floor, a replay traced, and the
   step timed by part.
7. Training. fp32 loss and gradients on the card against fp64 (TF32
   off; the leaves and steps the models hold in fp32 in any dtype stay
   so) at full width and a cut depth: llama3-3b, mamba2-1.3b and
   deepseek-v2-lite-16b at 2 layers, recurrentgemma-9b at 3 (one unit),
   whisper-medium at 2 + 2, batch 2 x 64 (whisper with its 1500 frames):
   the loss within 1e-6 relative and every gradient leaf within a
   relative L2 of 1e-4, the worst leaf printed (deepseek prints its
   fp32/fp64 routing agreement and, after a flip, holds the leaves no flip
   reaches). Then ``repro_torch.launch.train.main`` trains full-width
   llama3-3b (all 28 layers, bf16) for 30 steps of 8 x 128 tokens at
   --lr 3e-4 after 5 warm-up steps, and fails unless every loss and
   gradient norm is finite and the last logged loss is below the first;
   it prints the median step split into forward+backward and the AdamW
   update (CUDA events), tokens/s and the peak memory beside the card's
   name and power limit, then the forward+backward peak at 8 x 512 with
   remat on and off (on must be lower). The checkpoint the run saved
   must load into a zeroed template bit for bit. The loaded weights are
   then served through the kernels, the launch counts set to 0 before: a
   64-token forward and prefill through flash attention and RMSNorm, and
   4 decode steps of 8 rows through decode attention, each launch held to
   its plain version on its inputs at BF16_REL_L2, the forward's logits
   to fp32 as phase 3 holds them; last, a loss through the kernels on
   params that require grad must raise the wrappers' ``RuntimeError``.
8. Distribution: the port's dry-run of (tinyllama-1.1b, train_4k) on the
   2x4 debug mesh and on the 2x16x16 production mesh over a fake process
   group, on this machine's torch, and of (whisper-medium, train_4k) on
   2x16x16; on 2x16x16 the FLOPs a rank must be at most 1.25 x the JAX
   package's (``tests/golden_dryrun_jax.json``) and the temp bytes at
   most 1.5 x, so the placed step's split and its memory do not depend on
   the torch release;
   then, on a one-rank NCCL group and its 1x1 mesh, full-width llama3-3b
   in bf16 with no kernels: phase 7's train step on params and AdamW
   state placed by the port's sharding rules must equal the plain step
   bit for bit (loss, gradient norm, every leaf); the dry-run's counts of
   that step must equal the card's (its argument bytes the allocator's
   requested bytes for the placed arguments, exactly, and
   ``memory_allocated``'s rise within the allocator's rounding; its FLOPs
   ``FlopCounterMode``'s; no collective bytes); a 64-token prefill and 4
   decode steps through placed params and a placed 2048-slot cache must
   give the plain path's logits bit for bit. Last, the dry-run's
   ``temp_size_bytes`` against the card: the placed train step (three
   times; then at 8 x 256 with remat on and off), the placed prefill into
   the 2048-slot cache and one placed decode step, each run once under
   the dry-run's counter on the card: the rise of the allocator's
   requested bytes' peak over the bytes requested just before must lie
   between the dry-run's temp bytes and those plus the step's new
   outputs, and equal the counter's own peak on the card, each within
   TEMP_SLACK of the rise; remat must lower both the count and the rise.
   No kernel may launch.
9. The capacity MoE dispatch (``moe_dispatch="capacity"``, the JAX
   package's routed form) and the chunked reference attention: (a)
   deepseek-v2-lite-16b (full width and depth) and llama4-scout-17b-a16e
   (2 layers) in bf16 through ``TorchBackend`` with the capacity dispatch:
   each CUDA graph's replay held to its eager step bit for bit as in phase
   4, the share of assignments the capacity drops at a decode step of 8
   rows and at a 64-token forward (deepseek's C is 1 row an expert at the
   decode step), phase 4's 8 requests under AGFT with the launches held to
   ``path_launches``, and the graphed decode step's median beside phase
   4's dense one, with the card's name and power limit (no claim); (b) on
   a one-rank NCCL group and its 1x1 mesh, no kernels: the capacity train
   step of deepseek-v2-lite-16b at full width cut to CAP_TRAIN_LAYERS
   layers at 8 x 128, and a prefill of CHUNK_BATCH x CHUNK_SEQ tokens of
   llama3-3b through the chunked reference attention, each placed must
   equal its plain form bit for bit, and the dry-run's temp_size_bytes of
   each must meet the allocator's requested bytes' rise within TEMP_SLACK
   as phase 8 (c) holds it; (c) before (b), on this machine's torch, the
   port's ``cost_extrapolated`` of deepseek-v2-lite-16b x train_4k with
   the capacity dispatch under the expert-parallel constraint on the 16x16
   mesh, held to the JAX package's (``tests/golden_variants_jax.json``) as
   ``tests/test_torch_variants.py`` holds it.

The last lines are a JSON object with each kernel's numbers (a row per
kernel and timed shape; its launches are those of the serve runs whose
path runs that shape, also given per model, phase 5's under
``"llama3-3b azure"``, phase 6's under ``"whisper-medium"``, phase 7's
under ``"llama3-3b trained"``, phase 9's under ``"<model> capacity"``)
and the
result line ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import math
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
# MLA decode in the latent space (B, T, H, R, RP, fewest and most valid
# slots a row): deepseek-v2-lite-16b at the benchmark's batch of 32 over
# its two caches, with the contexts of its two mixes (normal: prompts
# 256-1024 and up to 350 tokens out; short: up to 256 and 256)
MAIN_MLA = [(32, 2048, 16, 512, 64, 257, 1374),
            (32, 512, 16, 512, 64, 17, 511)]
SWEEP_MLA = [(4, 64, 4, 64, 16, 1, 64), (3, 520, 16, 512, 64, 1, 520)]
MLA_SCALE = (128 + 64) ** -0.5     # deepseek-v2-lite-16b's (nope + rope)^-0.5
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
# phase 6: whisper-medium at full width and depth (24 + 24 layers), driven
# through its model contract: batch 8 of 1500 frames, Whisper's 4-token
# start-of-transcript prompt, its 448-token text context, 64 greedy steps
WHISPER = "whisper-medium"
WHISPER_PARAMS = 811_112_448
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_MAX_LEN = 8, 4, 448
WHISPER_STEPS = 64
# phase 7: fp32 gradients against fp64 at full width and a cut depth
# (recurrentgemma-9b: one (rec, rec, attn) unit; whisper-medium: 2 + 2)
GRAD_LAYERS = {"llama3-3b": 2, "mamba2-1.3b": 2, "deepseek-v2-lite-16b": 2,
               "recurrentgemma-9b": 3, "whisper-medium": 2}
GRAD_BATCH = (2, 64)
# leaves held in fp32 in every config (Mamba-2's decay and skip, the RG-LRU's
# lambda), in the JAX package too: the fp64 run keeps them so
FP32_LEAVES = ("A_log", "D", "dt_bias", "lambda_param")
LOSS_REL_FP64 = 1e-6
GRAD_REL_L2_FP64 = 1e-4
# phase 7: full-width llama3-3b (all 28 layers, bf16) trained by the CLI,
# then its remat peaks, and its trained weights served through the kernels
TRAIN_ARCH = "llama3-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 30
TRAIN_LR, TRAIN_WARMUP = 3e-4, 5
REMAT_BATCH, REMAT_SEQ = 8, 512
SERVE_PROMPT, SERVE_MAX_LEN, SERVE_BATCH, SERVE_STEPS = 64, 2048, 8, 4
TRAINED_RUN = "llama3-3b trained"  # phase 7's key in the kernels line
# phase 8: the distribution layer on one card: the dry-run of this pair on
# the 2x4 debug mesh and on the 2x16x16 production mesh (its FLOPs a rank
# held to dryrun.JAX_FLOPS_BOUND x the JAX package's, read from
# DIST_GOLDEN: the split must not depend on the torch release), then
# full-width llama3-3b (bf16, no kernels) placed on a 1x1 mesh of a
# one-rank NCCL group: phase 7's 8 x 128 train step placed and plain, and
# a prefill of DIST_PROMPT tokens and DIST_STEPS decode steps through a
# DIST_SLOTS-slot cache of batch DIST_BATCH
DIST_DRYRUN = ("tinyllama-1.1b", "train_4k")
# and on 2x16x16 alone, held to dryrun.JAX_TEMP_BOUND x the JAX package's
# temp bytes: logits that the vocab split misses (51,865 over 16), whose
# loss each rank takes on its own rows
DIST_DRYRUN_TEMP = ("whisper-medium", "train_4k")
DIST_GOLDEN = os.path.join(HERE, "tests", "golden_dryrun_jax.json")
DIST_ARCH = "llama3-3b"
DIST_PROMPT, DIST_SLOTS, DIST_BATCH, DIST_STEPS = 64, 2048, 8, 4
# phase 9: the capacity dispatch served by these (at DEPTH), its runs'
# keys in the kernels line; its train step placed on 1x1 at full width,
# cut to the dense layer and two MoE layers; a chunked prefill placed
CAPACITY_MODELS = ("deepseek-v2-lite-16b", "llama4-scout-17b-a16e")
CAPACITY_RUNS = tuple(f"{m} capacity" for m in CAPACITY_MODELS)
CAP_ARCH, CAP_TRAIN_LAYERS = "deepseek-v2-lite-16b", 3
CHUNK_ARCH, CHUNK_BATCH, CHUNK_SEQ = "llama3-3b", 8, 1024
# and the dry-run of this variant on the card's torch, held to the JAX
# package's costs of it
VARIANT = ("deepseek-v2-lite-16b", "train_4k", "capacity_moe_ep")
VARIANT_GOLDEN = os.path.join(HERE, "tests", "golden_variants_jax.json")
# and its collective bytes by kind, pinned to the byte: the CPU tests' count
# (every collective one a placed op states, so the same on every release)
VARIANT_PINNED = os.path.join(HERE, "tests", "pinned_port_collectives.json")
# the graphed decode step's median of each AGFT serve run, by (model,
# dispatch): phase 9 prints the capacity dispatch's beside phase 4's
STEP_MS = {}
# the caching allocator's requested bytes are the bytes asked for, to the
# byte; the bytes it allocates round each block up to 512 and keep with a
# block cut from a large segment a remainder under 1 MiB (it splits off
# no less): allocated may exceed requested by under 1 MiB a leaf
ALLOC_SLACK = 1 << 20
# the dry-run's temp_size_bytes against the allocator's requested bytes'
# peak rise over a step: allocations inside an op that no op returns (a
# library's workspace, a sort's scratch) are not counted, and must fit in
# this share of the rise; the placed train step is measured TEMP_RUNS
# times with remat on, then at TRAIN_BATCH x TEMP_REMAT_SEQ with remat on
# and off (at TRAIN_SEQ the AdamW update's temporaries set the peak either
# way: remat lowers the peak only where the activations set it)
TEMP_SLACK = 0.02
TEMP_RUNS = 3
TEMP_REMAT_SEQ = 256
WHISPER_CHECKED = 3        # replays held to the eager step bit for bit
WHISPER_FP32_LAYERS = 4    # the fp32 checks: 4 encoder + 4 decoder layers
# its decoder's self-attention: 16 query heads over 16 kv heads of 64
# (G = 1), prefill at 1, 4 and 64 tokens and at the served (8, 4); decode
# against the 448-slot cache at the loop's valid counts, 5..68
G1_FLASH = [(1, S, 16, 16, 64) for S in (1, 4, 64)] + [(8, 4, 16, 16, 64)]
G1_DECODE = (8, WHISPER_MAX_LEN, 16, 16, 64)
G1_VALID = (WHISPER_PROMPT + 1, WHISPER_PROMPT + WHISPER_STEPS)
# each timed row of the kernels line: its kernel, and the serve runs whose
# path launches that kernel at the row's shape (the row counts theirs)
ROWS = {"rmsnorm": ("rmsnorm", MODELS + (AZURE_RUN, TRAINED_RUN)
                    + CAPACITY_RUNS),
        "add_rmsnorm": ("rmsnorm_fused", MODELS + (AZURE_RUN, TRAINED_RUN)
                        + CAPACITY_RUNS),
        "flash_attention": ("flash_attention", ("llama3-3b", AZURE_RUN,
                                                TRAINED_RUN)),
        "flash_attention_g5": ("flash_attention",
                               ("llama4-scout-17b-a16e",
                                "llama4-scout-17b-a16e capacity")),
        "decode_attention": ("decode_attention", ("llama3-3b", AZURE_RUN,
                                                  TRAINED_RUN)),
        "decode_attention_g5": ("decode_attention",
                                ("llama4-scout-17b-a16e",
                                 "llama4-scout-17b-a16e capacity")),
        "decode_attention_d256_g16": ("decode_attention",
                                      ("recurrentgemma-9b",)),
        "ssd_scan": ("ssd_scan", ("mamba2-1.3b",)),
        "ssd_scan_c128": ("ssd_scan", ()),
        "rglru_scan": ("rglru_scan", ("recurrentgemma-9b",)),
        "rglru_gated_scan": ("rglru_gated", ("recurrentgemma-9b",)),
        "rglru_gated_scan_step": ("rglru_gated_step",
                                  ("recurrentgemma-9b",)),
        "flash_attention_g1": ("flash_attention", (WHISPER,)),
        "decode_attention_g1": ("decode_attention", (WHISPER,)),
        "mla_decode": ("mla_decode", ("deepseek-v2-lite-16b",
                                      "deepseek-v2-lite-16b capacity")),
        "mla_decode_s512": ("mla_decode", ())}
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
    """Median device time of one call, in ms (``device_times``)."""
    return statistics.median(device_times(torch, fn, reps, warmup))


def device_times(torch, fn, reps: int = 30, warmup: int = 3):
    """The device time of each of ``reps`` calls, in ms, from CUDA events. A
    sleep kernel enqueued first keeps the card busy while the host enqueues
    the call, so the events bracket device work, not host overhead."""
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
    return times


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


def mla_inputs(torch, gen, B, T, H, R, RP, lo, hi, dt):
    """q (B, H, R + RP), c_kv (B, T, R), k_rope (B, T, RP) from unit
    normals and valid (B, T): each row's first lo..hi slots (a decode
    step's context and its own new entry)."""
    lengths = torch.randint(lo, hi + 1, (B,), generator=gen,
                            device=gen.device)
    valid = torch.arange(T, device=gen.device)[None] < lengths[:, None]
    return (randn(torch, gen, (B, H, R + RP), dt),
            randn(torch, gen, (B, T, R), dt),
            randn(torch, gen, (B, T, RP), dt), valid)


def tree_bytes(tree) -> int:
    """The bytes of a params or cache tree's tensors."""
    from repro_torch.models import tree_tensors
    return sum(t.numel() * t.element_size() for t in tree_tensors(tree))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(torch, dev):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as mla
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
    # MLA decode in the latent space, both dtypes; deepseek's scale
    for dn, dt in dtypes.items():
        for shape in SWEEP_MLA + MAIN_MLA:
            B, T, H, R, RP, lo, hi = shape
            args = mla_inputs(torch, gen, B, T, H, R, RP, lo, hi, dt)
            row = "mla_decode_s512" if T == 512 else "mla_decode"
            record(row, f"B{B} T{T} H{H} R{R} RP{RP} valid {lo}-{hi}", dn,
                   mla.mla_decode(*args, MLA_SCALE),
                   mla.mla_decode_plain(*args, MLA_SCALE),
                   shape in MAIN_MLA)
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
    # whisper-medium's decoder (G = 1, D 64), from a generator of its own:
    # flash at its prefill shapes; decode with each row's valid count one of
    # the decode loop's
    gen = torch.Generator(device=dev).manual_seed(5)
    for dn, dt in dtypes.items():
        for (B, S, H, Hkv, D) in G1_FLASH:
            q = randn(torch, gen, (B, S, H, D), dt)
            k = randn(torch, gen, (B, S, Hkv, D), dt)
            v = randn(torch, gen, (B, S, Hkv, D), dt)
            record("flash_attention_g1", f"B{B} S{S} H{H} Hkv{Hkv} D{D}", dn,
                   fa.flash_attention(q, k, v, causal=True),
                   fa.flash_attention_plain(q, k, v, causal=True), True)
        B, T, H, Hkv, D = G1_DECODE
        lengths = torch.randint(G1_VALID[0], G1_VALID[1] + 1, (B,),
                                generator=gen, device=dev)
        valid = torch.arange(T, device=dev)[None] < lengths[:, None]
        q = randn(torch, gen, (B, 1, H, D), dt)
        kc = randn(torch, gen, (B, T, Hkv, D), dt)
        vc = randn(torch, gen, (B, T, Hkv, D), dt)
        record("decode_attention_g1", f"B{B} T{T} H{H} Hkv{Hkv} D{D} valid "
               f"{G1_VALID[0]}-{G1_VALID[1]}", dn,
               dec.decode_attention(q, kc, vc, valid),
               dec.decode_attention_plain(q, kc, vc, valid), True)
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
    from repro_torch.kernels import mla_decode as mla
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
    def flash_timing(row, shape):
        B, S, H, Hkv, Dh = shape
        q = randn(torch, gen, (B, S, H, Dh), bf)
        k = randn(torch, gen, (B, S, Hkv, Dh), bf)
        v = randn(torch, gen, (B, S, Hkv, Dh), bf)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        nbytes = 2 * (2 * B * S * H * Dh + 2 * B * S * Hkv * Dh)
        flops = 4.0 * B * H * Dh * S * (S + 1) / 2
        b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
        return dict(
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
            kernel_us=kernel_us(torch, lambda: fa.flash_attention(q, k, v)))

    # flash prefill at the largest prefill bucket: llama3-3b's 24 query
    # heads over 8, llama4-scout-17b-a16e's 40 over 8
    rows.append(flash_timing("flash_attention", MAIN_FLASH[-1]))
    rows.append(flash_timing("flash_attention_g5", G5_FLASH[-1]))

    def decode_timing(shape, max_len, min_len=1):
        """The decode kernel against a cache of ragged validity: each row
        holds min_len..max_len tokens (past T: a ring that wrapped, all
        live)."""
        B, T, H, Hkv, Dh = shape
        q = randn(torch, gen, (B, 1, H, Dh), bf)
        kc = randn(torch, gen, (B, T, Hkv, Dh), bf)
        vc = randn(torch, gen, (B, T, Hkv, Dh), bf)
        lengths = torch.randint(min_len, max_len + 1, (B,), generator=gen,
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
    # MLA decode in the latent space at deepseek-v2-lite-16b's two caches
    # and mixes: bytes are each valid latent row once (R + RP bf16), q and
    # o; operations 2 H (R + RP + R) a valid slot. The library yardstick:
    # SDPA over the latents as one kv head (key and value built before)
    for row, shape in zip(("mla_decode", "mla_decode_s512"), MAIN_MLA):
        B, T, H, R, RP, lo, hi = shape
        q, c_kv, k_rope, valid = mla_inputs(torch, gen, B, T, H, R, RP, lo,
                                            hi, bf)
        n_valid = int(valid.sum())
        nbytes = 2 * (n_valid * (R + RP) + B * H * (R + RP) + B * H * R)
        b_ms, b_by = bound_ms(nbytes, 2.0 * H * n_valid * (2 * R + RP),
                              "bfloat16")
        kt = torch.cat([c_kv, k_rope], dim=-1)[:, None]
        vt, qt, mask = c_kv[:, None], q[:, :, None], valid[:, None, None]

        def call():
            return mla.mla_decode(q, c_kv, k_rope, valid, MLA_SCALE)
        rows.append(dict(
            name=row, route="cuda",
            source="src/repro_torch/csrc/mla_decode.cu",
            replaces="none: src/repro/models/attention.py:mla_decode's "
                     "up-projected einsums",
            shape=f"q ({B}, {H}, {R + RP}), latents ({B}, {T}, {R} + "
                  f"{RP}), {n_valid} valid slots, bf16; "
                  f"{mla.grid_plan(B, T, mla._num_sms(0))} first-pass "
                  "blocks",
            ms=device_ms(torch, call),
            plain_ms=device_ms(torch, lambda: mla.mla_decode_plain(
                q, c_kv, k_rope, valid, MLA_SCALE)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True,
                scale=MLA_SCALE), "mla_decode"),
            kernel_us=kernel_us(torch, call)))
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
    # whisper-medium's decoder (G = 1, D 64): flash at its served prefill
    # (8 prompts of 4 tokens), decode against its 448-slot cache with each
    # row's valid count one of the decode loop's
    rows.append(flash_timing("flash_attention_g1", G1_FLASH[-1]))
    rows.append(dict(
        name="decode_attention_g1", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:57",
        **decode_timing(G1_DECODE, G1_VALID[1], G1_VALID[0])))
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
    nbytes = tree_bytes(backend.params)
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
    ``cache_len`` slots at ``context``, and within MLA decode its
    latent-space attention kernel), times the layers that run it. The
    layer's weights meet the part cold, as in a step; the latent cache
    (16.8 MB a layer) stays in L2 between calls, as it does not in a
    step."""
    from repro_torch.kernels import ops as kops
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
        q = randn(torch, gen, (B, cfg.num_heads,
                               cfg.kv_lora_rank + cfg.qk_rope_head_dim), dt)
        parts += [
            ("MLA decode", cfg.num_layers,
             lambda: attn.mla_decode(lp["attn"], cfg, h, cache, slots, rope)),
            ("  its latent-space attention kernel", cfg.num_layers,
             lambda: kops.mla_decode(q, cache.c_kv, cache.k_rope,
                                     slots.valid, MLA_SCALE))]
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
    if policy_name == "agft":
        STEP_MS[(cfg.name, cfg.moe_dispatch)] = step_ms
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
    under MLA the latent-space MLA decode L instead (an MoE model's norms
    are the dense model's: 2L+1, its latents' norm staying plain, as in the
    JAX package);
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
    if cfg.use_mla:     # MLA's prefill attends by einsum, as in JAX
        return {**norms, "mla_decode": L * dec}
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
    call, and the top device kernels and host ops (``trace_form``)."""
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
            trace_form(torch, label, step, steps, timed)


def trace_form(torch, label, step, steps: int = 4, timed: int = 20):
    """One form of ``trace_steps``: the median wall time of ``timed`` calls
    of ``step``, each ended by a synchronize, then ``traced`` over
    ``steps`` calls, with the busy share, the kernels a call, the top
    device kernels, the port's kernels and the top host ops; returns the
    busy ms, the busy share and the kernels a call."""
    from torch.autograd import DeviceType
    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(timed):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    events, wall = traced(torch, step, steps, cpu=True)
    # CPU ops also carry their kernels' device time: count the device-side
    # kernel events alone (not the span of the profiler's step, which is a
    # device-side event too)
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
    return dict(busy_ms=busy, busy_share=busy / (1e3 * wall),
                kernels=sum(e.count for e in kernels) // steps)


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
# phase 6: whisper-medium through its model contract
# ---------------------------------------------------------------------------

def serve_whisper(torch, dev):
    """Phase 6: full-width whisper-medium (bf16 weights from a seeded
    generator) on 8 x 1500 random frames and a 4-token prompt. The fp32
    and bf16 checks (``whisper_checks``), then ``whisper_loop``: encode and
    prefill, 64 greedy decode steps as a CUDA graph's replays, their
    launches, the replays held to the eager step, the times and the step by
    part. Returns the loop's launch counts."""
    import numpy as np
    from repro_torch.models import build_model, tree_tensors
    cfg = model_config(WHISPER)
    B, P = WHISPER_BATCH, WHISPER_PROMPT
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = build_model(cfg).init(gen)
        frames = randn(torch, gen, (B, cfg.encoder_seq, cfg.d_model),
                       torch.bfloat16)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, P + 1))).to(dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_tensors(params))
        say(f"  {cfg.name}: {n_params:,} params ({cfg.encoder_layers} "
            f"encoder + {cfg.num_layers} decoder layers, d_model "
            f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}), bf16, "
            f"{tree_bytes(params) / 1e9:.3f} GB; frames {tuple(frames.shape)}"
            f", prompt {P} tokens; init {time.perf_counter() - t0:.1f} s")
        if n_params != WHISPER_PARAMS:
            fail(f"{cfg.name}: {n_params} params, not the full width's "
                 f"{WHISPER_PARAMS}")
        whisper_checks(torch, dev, cfg, params, frames, toks)
        counts = whisper_loop(torch, dev, cfg, params, frames, toks)
    del params, frames
    say(f"  phase 6: {time.perf_counter() - t0:.1f} s wall")
    return counts


def whisper_checks(torch, dev, cfg, params, frames, toks):
    """fp32, cut to WHISPER_FP32_LAYERS encoder and decoder layers (each
    bf16 weight widened where it is used): logits through the kernels
    against the plain versions to FP32_REL_L2, and the prefill->decode
    contract against the teacher-forced forward at the model tests'
    tolerances. bf16 at full depth: the kernels' logits no further from the
    fp32 logits than BF16_VS_PLAIN x the plain versions'."""
    from repro_torch.models import build_model
    B, P, L = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_FP32_LAYERS
    f32 = dict(dtype="float32", param_dtype="float32")
    c32 = cfg.replace(num_layers=L, encoder_layers=L, **f32)
    p32 = dict(params, enc_layers=params["enc_layers"][:L],
               dec_layers=params["dec_layers"][:L])
    frames32 = frames.float()
    ker = build_model(c32.replace(use_pallas=True))
    l32 = build_model(c32).forward(p32, toks, frames32)[0]
    l32k = ker.forward(p32, toks, frames32)[0]
    e32 = rel_l2(torch, l32k, l32)
    say(f"  fp32 logits {tuple(l32.shape)} at {L} + {L} layers (cut from "
        f"{cfg.encoder_layers} + {cfg.num_layers}): kernels vs plain rel-L2 "
        f"{e32:.3e} (tol {FP32_REL_L2})")
    pl, cache = ker.prefill(p32, toks[:, :P], frames32,
                            max_len=WHISPER_MAX_LEN)
    pos = torch.full((B,), P, dtype=torch.long, device=dev)
    dl, _ = ker.decode_step(p32, toks[:, P:], cache, pos)
    e_pf, ok_pf = close(torch, pl[:, 0], l32k[:, P - 1], "prefill")
    e_de, ok_de = close(torch, dl[:, 0], l32k[:, P], "decode")
    say(f"  fp32 prefill->decode contract through the kernels: prefill max "
        f"abs {e_pf:.3e} (tol {TOL['prefill'][1]}), decode {e_de:.3e} (tol "
        f"{TOL['decode'][1]})")
    del cache, l32, l32k
    if e32 > FP32_REL_L2 or not (ok_pf and ok_de):
        fail(f"{cfg.name}: fp32 model through the kernels disagrees with the "
             "plain versions or breaks the prefill->decode contract")
    l32 = build_model(cfg.replace(**f32)).forward(params, toks, frames32)[0]
    lk = build_model(cfg.replace(use_pallas=True)).forward(params, toks,
                                                          frames)[0]
    lp = build_model(cfg).forward(params, toks, frames)[0]
    e_k, e_p = rel_l2(torch, lk, l32), rel_l2(torch, lp, l32)
    say(f"  bf16 logits vs fp32 at {cfg.encoder_layers} + {cfg.num_layers} "
        f"layers: kernels rel-L2 {e_k:.3e}, plain {e_p:.3e} (kernels <= "
        f"{BF16_VS_PLAIN} x plain); kernels vs plain "
        f"{rel_l2(torch, lk, lp):.3e}")
    if not bool(torch.isfinite(lk).all()) or e_k > BF16_VS_PLAIN * e_p:
        fail(f"{cfg.name}: bf16 logits through the kernels are further from "
             "fp32 than the plain versions'")


def whisper_loop(torch, dev, cfg, params, frames, toks):
    """The decode step captured once as a ``StepGraph`` on static token,
    pos and cache; then, the launch counts set to 0: the prefill (its
    encoder included), its cache copied into the static one in place, and
    WHISPER_STEPS greedy steps, each a replay fed the last one's argmax on
    the card. Fails unless the prefill launched flash attention once a
    decoder layer, each step decode attention once a layer, and nothing
    else; the first WHISPER_CHECKED replays equal the eager step bit for
    bit (logits and the self cache), and the cross cache is unchanged.
    Then times and traces the path (``whisper_times``)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model, tree_clone, tree_tensors
    from repro_torch.serving.graphs import StepGraph
    B, P, L = WHISPER_BATCH, WHISPER_PROMPT, cfg.num_layers
    model = build_model(cfg.replace(use_pallas=True))
    static = model.init_cache(B, WHISPER_MAX_LEN, device=dev)
    token = torch.zeros((B, 1), dtype=torch.long, device=dev)
    pos = torch.full((B,), P, dtype=torch.long, device=dev)
    graph = StepGraph(
        lambda: model.decode_step(params, token, static, pos)[0], dev,
        name=f"{cfg.name} decode_step")
    say(f"  decode step captured in {graph.capture_s:.2f} s (warm-up "
        f"included), holding {graph.memory_bytes / 2**20:.1f} MiB; a replay "
        f"launches {graph.launches}")
    torch.cuda.synchronize()
    reset_launch_counts()                 # count the main path alone
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, toks[:, :P], frames,
                                  max_len=WHISPER_MAX_LEN)
    after_prefill = launch_counts()
    for dst, src in zip(tree_tensors(static), tree_tensors(cache)):
        dst.copy_(src)
    token.copy_(logits.argmax(-1))
    kept = []
    for step in range(WHISPER_STEPS):
        out = graph()
        if step < WHISPER_CHECKED:
            kept.append((out.clone(), tree_clone(static["self"])))
        token.copy_(out.argmax(-1))
        pos.add_(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    finite = bool(torch.isfinite(out).all())
    say(f"  prefill + {WHISPER_STEPS} graphed greedy steps: {wall:.3f} s "
        f"wall; launches after the prefill {after_prefill}, after the steps "
        f"{counts}; last logits finite {finite}; last tokens "
        f"{token[:, 0].tolist()}")
    want_prefill = {"flash_attention": L}
    want = {"flash_attention": L, "decode_attention": L * WHISPER_STEPS}
    # the first replays against the eager step from the prefill's cache
    tok = logits.argmax(-1)
    eager_pos = torch.full((B,), P, dtype=torch.long, device=dev)
    bad = []
    for i, (lg, self_c) in enumerate(kept):
        eager, cache = model.decode_step(params, tok, cache, eager_pos)
        same = [torch.equal(a, b) for a, b in zip(self_c, cache["self"])]
        if not (torch.equal(lg, eager) and all(same)):
            bad.append(f"step {i}: logits {torch.equal(lg, eager)}, self "
                       f"cache tensors equal {sum(same)}/{len(same)}")
        tok, eager_pos = eager.argmax(-1), eager_pos + 1
    cross_same = all(torch.equal(static[k], cache[k])
                     for k in ("cross_k", "cross_v"))
    say(f"  graph vs eager, bit for bit: the first {WHISPER_CHECKED} steps' "
        f"logits and self cache: {'ok' if not bad else bad}; cross cache "
        f"unchanged by {WHISPER_STEPS} replays: {cross_same}")
    checks = {
        f"{n} launches after the prefill == {want_prefill.get(n, 0)}":
            after_prefill[n] == want_prefill.get(n, 0)
        for n in after_prefill}
    checks.update({f"{n} launches == {want.get(n, 0)}":
                   counts[n] == want.get(n, 0) for n in counts})
    checks.update({"replays equal the eager steps": not bad,
                   "cross cache unchanged": cross_same,
                   "logits finite": finite})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        fail(f"{cfg.name} decode loop: " + "; ".join(failed))
    del cache, kept
    whisper_times(torch, dev, model, params, frames, toks, graph, static,
                  pos)
    return counts


def whisper_times(torch, dev, model, params, frames, toks, graph, static,
                  pos):
    """encode, the 4-token prefill (its encoder and cross K/V included) and
    the graphed decode step (median and p90 at the loop's last position)
    from CUDA events, beside the step's floor: the decoder's weights but
    its cross wk/wv, and the lm_head, read once, and the whole cross
    cache. A traced replay (busy share, kernels a step), then the step by
    part: one layer's part timed alone on the model's own weights and the
    static cache, times the layers that run it."""
    from repro_torch.models import attention as attn
    from repro_torch.models import blocks
    from repro_torch.models.common import layer_norm
    cfg = model.cfg
    P, L = WHISPER_PROMPT, cfg.num_layers
    enc_ms = device_ms(torch, lambda: model.encode(params, frames), reps=10)
    pre_ms = device_ms(torch, lambda: model.prefill(
        params, toks[:, :P], frames, max_len=WHISPER_MAX_LEN), reps=10)
    steps = device_times(torch, graph, reps=50)
    med = statistics.median(steps)
    p90 = statistics.quantiles(steps, n=10)[-1]
    weights = (tree_bytes(params["dec_layers"]) + tree_bytes(
        params["lm_head"]) + tree_bytes(params["dec_final_norm"]) - sum(
        tree_bytes(lp["cross_attn"][k]) for lp in params["dec_layers"]
        for k in ("wk", "wv")))
    cross = tree_bytes(static["cross_k"]) + tree_bytes(static["cross_v"])
    floor = 1e3 * (weights + cross) / HBM_BYTES_PER_S
    context = int(pos[0])
    say(f"  encode {enc_ms:.3f} ms; prefill of {P} tokens {pre_ms:.3f} ms "
        f"(encoder and cross K/V included); graphed decode step at context "
        f"{context}: median {med:.3f} ms, p90 {p90:.3f} ms of {len(steps)}; "
        f"floor {floor:.3f} ms ({weights / 1e9:.3f} GB of weights and "
        f"{cross / 1e9:.3f} GB of cross cache at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {med / floor:.2f}x)")
    tr = trace_form(torch, f"graph decode step (context {context}, batch "
                    f"{WHISPER_BATCH})", graph)
    gen = torch.Generator(device=dev).manual_seed(6)
    lp = params["dec_layers"][0]
    h = randn(torch, gen, (WHISPER_BATCH, 1, cfg.d_model),
              cfg.activation_dtype)
    slots = attn.decode_slots(cfg, WHISPER_MAX_LEN, pos)
    self_c = attn.KVCache(static["self"].k[0], static["self"].v[0])
    ck, cv = static["cross_k"][0], static["cross_v"][0]
    ln = lp["ffn_norm"]
    parts = [
        ("self-attention (projections, cache write, decode kernel)", L,
         lambda: attn.attention_decode(lp["self_attn"], model.self_cfg, h,
                                       self_c, slots, None)),
        ("cross-attention (plain gqa_attention, fp32)", L,
         lambda: attn.cross_attention(lp["cross_attn"], cfg, h, ck, cv)),
        ("  its fp32 casts of the encoder K/V", L,
         lambda: (ck.float(), cv.float())),
        ("FFN", L, lambda: blocks.ffn_forward(lp["ffn"], cfg, h)),
        ("LayerNorm", 3 * L, lambda: layer_norm(h, ln["w"], ln["b"])),
        ("final norm and lm_head", 1, lambda: model._unembed(params, h))]
    say(f"  decode step by part (batch {WHISPER_BATCH}, one layer's part "
        "timed alone, x layers):")
    total = 0.0
    for name, n, fn in parts:
        ms = device_ms(torch, fn)
        total += 0.0 if name.startswith(" ") else n * ms
        say(f"    {name}: {ms:.4f} ms x {n} = {n * ms:.3f} ms")
    say(f"    sum of the parts {total:.3f} ms against the graphed step's "
        f"{med:.3f} ms (busy {tr['busy_ms']:.3f} ms, "
        f"{100 * tr['busy_share']:.1f}%, {tr['kernels']} kernels a step)")
    whisper_kernel_options(torch, gen, model, params, h, ck, cv, enc_ms)


def whisper_kernel_options(torch, gen, model, params, h, ck, cv, enc_ms):
    """What the two attentions that the JAX package computes without a
    kernel would take through the port's kernels (neither is on the path;
    the launches here come after the path's counts were read), each beside
    its plain version on the same inputs: one layer's cross-attention
    against the 1500 encoder frames through the decode kernel, every slot
    valid, and one encoder layer's bidirectional attention through the
    non-causal flash kernel at S = 1500."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn
    cfg = model.cfg
    B, T, L = WHISPER_BATCH, cfg.encoder_seq, cfg.num_layers
    q = (h @ params["dec_layers"][0]["cross_attn"]["wq"]).reshape(
        B, 1, cfg.num_heads, cfg.head_dim)
    valid = torch.ones((B, T), dtype=torch.bool, device=h.device)
    x = randn(torch, gen, (B, T, cfg.d_model), cfg.activation_dtype)
    qe, ke, ve = attn._project_qkv(params["enc_layers"][0]["attn"],
                                   model.self_cfg, x, cfg.num_kv_heads)
    say("  the attentions JAX computes without a kernel, through the port's "
        "kernels (one layer each, timed alone; not on the path):")
    for name, n, plain, kernel in (
            (f"cross-attention, q (B{B}, 1) over {T} frames: decode kernel",
             L, lambda: attn.gqa_attention(q, ck, cv, None),
             lambda: dec.decode_attention(q, ck, cv, valid)),
            (f"encoder attention (B{B}, S{T}): non-causal flash kernel",
             cfg.encoder_layers, lambda: attn.gqa_attention(qe, ke, ve, None),
             lambda: fa.flash_attention(qe, ke, ve, causal=False))):
        err = rel_l2(torch, kernel(), plain())
        p_ms = device_ms(torch, plain, reps=10)
        k_ms = device_ms(torch, kernel, reps=10)
        say(f"    {name}: plain {p_ms:.4f} ms x {n} = {n * p_ms:.3f} ms, "
            f"kernel {k_ms:.4f} ms x {n} = {n * k_ms:.3f} ms; kernel vs "
            f"plain rel-L2 {err:.3e}"
            f"{'' if err <= BF16_REL_L2 else ' (disagrees: not usable)'}")
    say(f"    (encode took {enc_ms:.3f} ms in all)")


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------

def leaf_paths(tree, prefix=""):
    """The dotted path of each tensor of a params tree, in the order of
    ``tree_tensors``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1]


def grad_config(name):
    """The model at full width, cut to its GRAD_LAYERS."""
    n = GRAD_LAYERS[name]
    cfg = model_config(name).replace(num_layers=n)
    return cfg.replace(encoder_layers=n) if cfg.is_encoder_decoder else cfg


def grads_vs_fp64(torch, dev, cfg):
    """fp32 loss and gradients on the card against fp64, TF32 off: fp32
    weights from a seeded generator and the same widened to fp64,
    GRAD_BATCH tokens (whisper's frames too, fp32 and fp64); FP32_LEAVES
    stay fp32, and the steps that the models compute in fp32 in any dtype
    (the norms' statistics, attention's scores) stay so. The loss must
    lie within LOSS_REL_FP64 and each gradient leaf within a relative L2 of
    GRAD_REL_L2_FP64 of fp64's; the worst leaf is printed. An MoE model
    first compares its routing in the two precisions (``routings``,
    ``routing_flips``, as phase 3): after a flip, the tokens it reaches
    leave the loss (its mask), and only the leaves no flip reaches are
    held: the final norm, the lm_head and the experts (not the router) of
    the MoE layers from the last flip on, since the load-balance loss
    carries a flip to the router and to every leaf before it."""
    import numpy as np
    from repro_torch.models import build_model, tree_map, tree_tensors
    t0 = time.perf_counter()
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    cfg64 = cfg.replace(dtype="float64", param_dtype="float64")
    m32, m64 = build_model(cfg32), build_model(cfg64)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m32.init(gen)
    B, S = GRAD_BATCH
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1))).to(dev)
    args32 = [toks[:, :-1], toks[:, 1:]]
    args64 = list(args32)
    if cfg.is_encoder_decoder:
        frames = randn(torch, gen, (B, cfg.encoder_seq, cfg.d_model),
                       torch.float32)
        args32.append(frames)
        args64.append(frames.double())
    names = list(leaf_paths(params))
    n_params = sum(t.numel() for t in tree_tensors(params))
    kw, held = {}, set(names)
    if cfg.num_experts:
        with torch.no_grad():
            _, r32 = routings(lambda: m32.forward(params, args32[0]))
            paths = iter(names)
            p64 = tree_map(lambda t: t if next(paths).split(".")[-1] in
                           FP32_LEAVES else t.double(), params)
            _, r64 = routings(lambda: m64.forward(p64, args64[0]))
            del p64
        agree, keep = routing_flips(torch, r32, r64)
        flipped = [i for i, (a, b) in enumerate(zip(r32, r64)) if not
                   torch.equal(a.sort(-1).values, b.sort(-1).values)]
        say(f"  {cfg.name}: routing, fp32 vs fp64: agree on {agree:.6f} of "
            f"the {sum(r.numel() for r in r32)} (token, expert) choices; "
            f"{int(keep.sum())} of {keep.numel()} tokens reached by no flip")
        if flipped:
            if not bool(keep.any()):
                fail(f"{cfg.name}: a routing flip reaches every token")
            kw["mask"] = keep.float()
            held = {n for n in names if n in ("final_norm", "lm_head") or (
                n.startswith("layers.") and ".moe." in n
                and not n.endswith(".router")
                and int(n.split(".")[1]) >= flipped[-1])}
    for t in tree_tensors(params):
        t.requires_grad_(True)
    loss = m32.loss(params, *args32, **kw)
    loss.backward()
    loss32 = loss.item()        # the graph's leaves go with the tensor
    g32 = [t.grad for t in tree_tensors(params)]
    paths = iter(names)
    params64 = tree_map(lambda t: (t.detach() if next(paths).split(".")[-1]
                                   in FP32_LEAVES else t.detach().double()
                                   ).requires_grad_(True), params)
    del loss, params
    loss = m64.loss(params64, *args64, **kw)
    loss.backward()
    loss64 = loss.item()
    del loss
    errs = {}
    for n, g, p in zip(names, g32, tree_tensors(params64)):
        if n in held:
            errs[n] = float(torch.linalg.vector_norm(g.double() - p.grad)
                            / torch.linalg.vector_norm(p.grad))
    worst = max(errs, key=errs.get)
    e_loss = abs(loss32 - loss64) / abs(loss64)
    say(f"  {cfg.name} at {cfg.num_layers} layers"
        f"{' + ' + str(cfg.encoder_layers) if cfg.is_encoder_decoder else ''}"
        f": {n_params / 1e9:.3f} B params, batch {B} x {S}; loss fp32 "
        f"{loss32:.7f}, fp64 {loss64:.9f}, rel err {e_loss:.3e} (tol "
        f"{LOSS_REL_FP64}); {len(errs)} of {len(names)} gradient leaves "
        f"held, worst rel-L2 {errs[worst]:.3e} at {worst} (tol "
        f"{GRAD_REL_L2_FP64}); {time.perf_counter() - t0:.1f} s")
    del g32, params64
    torch.cuda.empty_cache()
    if not (e_loss <= LOSS_REL_FP64 and all(
            e <= GRAD_REL_L2_FP64 for e in errs.values())):
        fail(f"{cfg.name}: fp32 loss or gradients on the card disagree with "
             "fp64")


def train_full(torch, dev, ckpt):
    """``repro_torch.launch.train.main`` on full-width, full-depth
    TRAIN_ARCH in bf16: TRAIN_BATCH x TRAIN_SEQ tokens a step, TRAIN_STEPS
    steps at --lr TRAIN_LR after TRAIN_WARMUP warm-up steps
    (``AdamWConfig``), the trained params saved to ``ckpt``. Each step's
    forward+backward and AdamW update are timed with CUDA events around
    the train loop's own step and ``adamw_update`` (wrapped for this run).
    Fails unless every step's loss and gradient norm are finite and the
    last logged loss is below the first. Returns the trained params."""
    from repro_torch.launch import train as train_cli
    from repro_torch.training import AdamWConfig, train_loop
    starts, updates, metrics = [], [], []
    real_make, real_update = train_loop.make_train_step, \
        train_loop.adamw_update

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def timed_update(*args):
        e0 = event()
        out = real_update(*args)
        updates.append((e0, event()))
        return out

    def timed_make(model, opt_cfg):
        step = real_make(model, opt_cfg)

        def timed_step(*args):
            starts.append(event())
            out = step(*args)
            metrics.append(out[2])
            return out

        return timed_step

    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
            "--seed", "0", "--checkpoint", ckpt, "--device", str(dev)]
    say(f"  python -m repro_torch.launch.train {' '.join(argv)} "
        f"(AdamWConfig(warmup_steps={TRAIN_WARMUP}))")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_loop.make_train_step = timed_make
    train_loop.adamw_update = timed_update
    try:
        params, history = train_cli.main(
            argv, opt_cfg=AdamWConfig(warmup_steps=TRAIN_WARMUP))
    finally:
        train_loop.make_train_step = real_make
        train_loop.adamw_update = real_update
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    fb = [s.elapsed_time(u0) for s, (u0, _) in zip(starts, updates)]
    up = [u0.elapsed_time(u1) for u0, u1 in updates]
    step_ms = [a + b for a, b in zip(fb[1:], up[1:])]   # the first warms up
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    finite = all(math.isfinite(x) for x in losses + gnorms)
    med = statistics.median(step_ms)
    say(f"  card: {card_line()}")
    say(f"  {len(metrics)} steps, {wall:.1f} s wall with the init and the "
        f"checkpoint; losses {losses[0]:.4f} -> {losses[-1]:.4f}, logged "
        f"{[round(h['loss'], 4) for h in history]}; grad norms "
        f"{gnorms[0]:.3f} -> {gnorms[-1]:.3f}; all finite {finite}")
    say(f"  step (median of steps 2-{len(metrics)}, CUDA events): "
        f"forward+backward {statistics.median(fb[1:]):.3f} ms, AdamW update "
        f"{statistics.median(up[1:]):.3f} ms, step {med:.3f} ms (p90 "
        f"{sorted(step_ms)[int(0.9 * (len(step_ms) - 1))]:.3f}); first step "
        f"{fb[0]:.3f} + {up[0]:.3f} ms; "
        f"{TRAIN_BATCH * TRAIN_SEQ / (med / 1e3):.0f} tokens/s; peak memory "
        f"{peak / 1e9:.3f} GB (torch.cuda.max_memory_allocated)")
    if len(metrics) != TRAIN_STEPS or not finite or not \
            history[-1]["loss"] < history[0]["loss"]:
        fail(f"{TRAIN_ARCH} training: a loss or gradient norm not finite, "
             "or the last logged loss not below the first")
    return params


def remat_peaks(torch, dev, cfg, params):
    """The forward+backward peak memory of a loss at REMAT_BATCH x REMAT_SEQ
    with remat on and off (``torch.cuda.max_memory_allocated``, from the
    memory held before it: the params), each pass timed once with CUDA
    events. Fails unless remat's peak is the lower."""
    import numpy as np
    from repro_torch.models import build_model, tree_tensors
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (REMAT_BATCH, REMAT_SEQ + 1))).to(dev)
    peaks = {}
    for remat in (True, False):
        model = build_model(cfg.replace(remat=remat))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model.loss(params, toks[:, :-1], toks[:, 1:]).backward()
        end.record()
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated()
        say(f"  remat {'on ' if remat else 'off'}: forward+backward at "
            f"{REMAT_BATCH} x {REMAT_SEQ}: peak {peaks[remat] / 1e9:.3f} GB "
            f"({(peaks[remat] - base) / 1e9:.3f} GB over the "
            f"{base / 1e9:.3f} GB held before), one pass "
            f"{start.elapsed_time(end):.3f} ms")
        for t in tree_tensors(params):
            t.grad = None
    if not peaks[True] < peaks[False]:
        fail("remat did not lower the forward+backward peak")


def serve_trained(torch, dev, cfg, params):
    """The trained weights (requiring no grad) in a ``use_pallas`` model:
    the SERVE_PROMPT-token forward and prefill (batch 1, a 2048-slot
    cache) through flash attention and RMSNorm, then the cache copied to
    8 rows and SERVE_STEPS decode steps of 8 tokens through decode
    attention, the launch counts set to 0 before. Each launch's output is
    held to its plain version on the same inputs at BF16_REL_L2; the
    forward's logits to an fp32 forward of the same weights as phase 3
    holds them (no further than BF16_VS_PLAIN x the plain bf16 path's);
    each decode step's logits against the plain path's, printed. Then a
    ``loss`` with the kernels on params that require grad must raise the
    wrappers' ``RuntimeError``. Returns the launch counts."""
    import numpy as np
    from repro_torch.kernels import (launch_counts, ops, ref,
                                     reset_launch_counts)
    from repro_torch.models import build_model, tree_map, tree_tensors
    ker, plain = build_model(cfg.replace(use_pallas=True)), build_model(cfg)
    S, T, B, L = SERVE_PROMPT, SERVE_MAX_LEN, SERVE_BATCH, cfg.num_layers
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, S))).to(dev)
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (SERVE_STEPS, B, 1))).to(dev)
    errs = {}
    real = {n: getattr(ops, n) for n in ("rmsnorm", "add_rmsnorm",
                                         "flash_attention",
                                         "decode_attention")}

    def held(name):
        def call(*args, **kw):
            out = real[name](*args, **kw)
            want = getattr(ref, name)(*args, **kw)
            pairs = zip(out, want) if isinstance(out, tuple) else \
                [(out, want)]
            errs.setdefault(name, []).extend(rel_l2(torch, o, w)
                                             for o, w in pairs)
            return out
        return call

    def run(model):
        """The forward's logits, and the decode steps' logits."""
        logits = model.forward(params, prompt)[0]
        _, cache = model.prefill(params, prompt, max_len=T)
        cache = tree_map(lambda t: t.repeat_interleave(B, dim=1).contiguous(),
                         cache)
        pos = torch.full((B,), S, dtype=torch.long, device=dev)
        dec = []
        for i in range(SERVE_STEPS):
            lg, cache = model.decode_step(params, steps[i], cache, pos + i)
            dec.append(lg)
        return logits, dec

    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launch_counts()                 # count the main path alone
        for n in real:
            setattr(ops, n, held(n))
        try:
            lk, dk = run(ker)
        finally:
            for n, fn in real.items():
                setattr(ops, n, fn)
        torch.cuda.synchronize()
        counts = launch_counts()
        lp, dp = run(plain)
        l32 = build_model(cfg.replace(dtype="float32", param_dtype="float32")
                          ).forward(params, prompt)[0]
    e_k, e_p = rel_l2(torch, lk, l32), rel_l2(torch, lp, l32)
    e_dec = [rel_l2(torch, a, b) for a, b in zip(dk, dp)]
    finite = all(bool(torch.isfinite(t).all()) for t in [lk] + dk)
    runs = 2 + SERVE_STEPS
    want = {"rmsnorm": (2 * L + 1) * runs, "rmsnorm_fused": 2 * L * runs,
            "flash_attention": 2 * L, "decode_attention": SERVE_STEPS * L}
    calls = {"rmsnorm": counts["rmsnorm"] - counts["rmsnorm_fused"],
             "add_rmsnorm": 2 * counts["rmsnorm_fused"],
             "flash_attention": counts["flash_attention"],
             "decode_attention": counts["decode_attention"]}
    say(f"  trained weights through the kernels: launches {counts}; each "
        "launch against its plain version on its inputs, worst rel-L2 "
        + ", ".join(f"{n} {max(e):.3e} ({len(e)})" for n, e in errs.items())
        + f" (tol {BF16_REL_L2})")
    say(f"  forward logits (1 x {S}) vs fp32: kernels rel-L2 {e_k:.3e}, "
        f"plain {e_p:.3e} (kernels <= {BF16_VS_PLAIN} x plain); kernels vs "
        f"plain {rel_l2(torch, lk, lp):.3e}; {SERVE_STEPS} decode steps of "
        f"{B} rows, kernels vs plain {[f'{e:.3e}' for e in e_dec]}; finite "
        f"{finite}")
    checks = {f"{n} launches == {want.get(n, 0)}": counts[n] == want.get(n, 0)
              for n in counts}
    checks.update({f"{n}: each launch held to its plain version":
                   len(errs.get(n, ())) == k
                   and all(e <= BF16_REL_L2 for e in errs[n])
                   for n, k in calls.items()})
    checks["forward logits no further from fp32 than the plain path's"] = \
        e_k <= BF16_VS_PLAIN * e_p
    checks["logits finite"] = finite
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        fail(f"{cfg.name} trained weights: " + "; ".join(failed))
    for t in tree_tensors(params):
        t.requires_grad_(True)
    try:
        ker.loss(params, prompt[:, :-1], prompt[:, 1:])
    except RuntimeError as e:
        if "has no gradient" not in str(e):
            raise
        say(f"  loss through the kernels on params that require grad "
            f"refused: {e}")
    else:
        fail("a loss through the kernels on params that require grad did "
             "not raise")
    return counts


def trace_train_step(torch, dev, cfg, params):
    """Where a train step's time goes: ``trace_form`` over the train loop's
    own step (``make_train_step``) on ``params``, from fresh AdamW moments,
    on one synthetic batch of TRAIN_BATCH x TRAIN_SEQ: its wall time, the
    device-busy share, the kernels a step and the top device kernels and
    host ops."""
    from repro_torch.data import synthetic_token_batches
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, init_adamw, make_train_step
    from repro_torch.training.train_loop import to_device
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    state = [init_adamw(params, opt_cfg)]
    step = make_train_step(build_model(cfg), opt_cfg)
    batch = to_device(next(synthetic_token_batches(
        cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=1)), dev)

    def one():
        _, state[0], _ = step(params, state[0], batch)

    trace_form(torch, f"train step ({TRAIN_BATCH} x {TRAIN_SEQ}, eager)",
               one, steps=2, timed=3)
    del state
    torch.cuda.empty_cache()


def train_phase(torch, dev):
    """Phase 7: fp32 gradients against fp64 for the five families, the
    full-depth training run, its checkpoint, a traced train step, remat's
    peaks and the trained weights served through the kernels. Returns that
    serve's counts."""
    from repro_torch.models import tree_map, tree_tensors
    from repro_torch.training import load_checkpoint
    t0 = time.perf_counter()
    for name in GRAD_LAYERS:
        grads_vs_fp64(torch, dev, grad_config(name))
    ckpt = os.path.join(HERE, "build", "train", f"{TRAIN_ARCH}.npz")
    params = train_full(torch, dev, ckpt)
    cfg = model_config(TRAIN_ARCH)
    t1 = time.perf_counter()
    template = tree_map(torch.zeros_like, params)
    loaded, _ = load_checkpoint(ckpt, template)
    del template
    same = [torch.equal(a, b) for a, b in zip(tree_tensors(params),
                                              tree_tensors(loaded))]
    size = os.path.getsize(ckpt)
    os.remove(ckpt)
    say(f"  checkpoint: {size / 1e9:.3f} GB; loaded into a zeroed template "
        f"in {time.perf_counter() - t1:.1f} s, {sum(same)} of {len(same)} "
        "leaves equal (torch.equal)")
    if not all(same):
        fail("the checkpoint did not restore the trained params bit for bit")
    trace_train_step(torch, dev, cfg, params)
    remat_peaks(torch, dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    counts = serve_trained(torch, dev, cfg, loaded)
    del loaded
    say(f"  phase 7: {time.perf_counter() - t0:.1f} s wall")
    return counts


# ---------------------------------------------------------------------------
# phase 8: the distribution layer
# ---------------------------------------------------------------------------

def dist_phase(torch, dev):
    """Phase 8: (a) the port's dry-run of DIST_DRYRUN on the 2x4 debug mesh
    and on the 2x16x16 production mesh over a fake group, on this
    machine's torch, the latter's FLOPs a rank within
    ``dryrun.JAX_FLOPS_BOUND`` x the JAX package's (DIST_GOLDEN); then on
    a one-rank NCCL
    group and its 1x1 mesh, full-width DIST_ARCH in bf16 with no kernels:
    (b) phase 7's train step on params and AdamW state placed by the
    port's rules equals the plain step bit for bit (loss, gradient norm,
    every updated leaf); (c) the dry-run's counts of that step (1x1, fake
    tensors) equal the card's: its argument bytes the memory the placed
    arguments took, its FLOPs ``FlopCounterMode``'s of the plain step and
    ``StepCounter``'s of the placed one, no collective bytes, and its
    ``temp_size_bytes`` the allocator's requested bytes' rise over the
    placed step (``hold_temp``; TEMP_RUNS runs, then remat on and off at
    TEMP_REMAT_SEQ); (d) a prefill and DIST_STEPS decode steps through
    placed params and a placed cache give the plain path's logits bit for
    bit, and the dry-run's prefill and decode step hold their
    ``temp_size_bytes`` to the card as (c) does. No kernel may launch."""
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    before = launch_counts()
    with open(DIST_GOLDEN) as f:
        golden = {(g["arch"], g["shape"], g["mesh"]): g
                  for g in json.load(f)["results"]}
    for (arch, shape), kw in ((DIST_DRYRUN, {"debug_mesh": True}),
                              (DIST_DRYRUN, {"multi_pod": True}),
                              (DIST_DRYRUN_TEMP, {"multi_pod": True})):
        r = dryrun.run_one(arch, shape, verbose=False, **kw)
        say(f"  (a) dry-run {arch} x {shape} x {r['mesh']} (fake group of "
            f"{r['devices']}): flops {r['flops']:.4e} (global "
            f"{r['flops_global']:.4e}), collective bytes "
            f"{r['collective_bytes']['total']}, argument bytes "
            f"{r['memory']['argument_size_bytes']}, temp bytes "
            f"{r['memory']['temp_size_bytes']}, {r['compile_s']} s")
        if "multi_pod" in kw:
            hold_to_jax(r, golden[(arch, shape, r["mesh"])], dryrun)
    counts = dist_counts(torch, dryrun)
    if dist.is_initialized():
        fail("the dry-run left a process group set up")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        say(f"  NCCL group of 1, mesh {mesh}")
        placed_train_step(torch, dev, mesh, counts)
        placed_decode(torch, dev, mesh, counts)
    finally:
        dist.destroy_process_group()
    if launch_counts() != before:
        fail(f"phase 8 launched port kernels: {before} -> {launch_counts()}")
    say(f"  phase 8: {time.perf_counter() - t0:.1f} s wall; no port kernel "
        "launched")


def hold_to_jax(r, ref, dryrun):
    """Print a production-mesh dry-run's FLOPs a rank, collective bytes,
    all-gather bytes and temp bytes over the JAX package's (``ref``, its
    row of DIST_GOLDEN), and fail above ``dryrun.JAX_FLOPS_BOUND`` on the
    FLOPs or ``dryrun.JAX_TEMP_BOUND`` on the temp bytes."""
    ext, name = ref["extrapolated"], f"{r['arch']} x {r['shape']} x {r['mesh']}"
    coll, ref_coll = r["collective_bytes"], ext["collective_bytes"]
    f = r["flops"] / ext["flops"]
    temp = r["memory"]["temp_size_bytes"] / ref["memory"]["temp_size_bytes"]
    say(f"  (a) {name}: flops a rank {r['flops']:.4e}, the JAX package's "
        f"{ext['flops']:.4e}: {f:.4f} x (bound {dryrun.JAX_FLOPS_BOUND}); "
        f"collective bytes {coll['total']:.4e} against "
        f"{ref_coll['total']:.4e}: {coll['total'] / ref_coll['total']:.4f} "
        f"x; all-gather {coll['all-gather']:.4e} against all-gather + "
        f"collective-permute {ref_coll['all-gather']:.4e} + "
        f"{ref_coll['collective-permute']:.4e}; temp bytes "
        f"{r['memory']['temp_size_bytes']:.4e} against "
        f"{ref['memory']['temp_size_bytes']:.4e}: {temp:.4f} x (bound "
        f"{dryrun.JAX_TEMP_BOUND})")
    if f > dryrun.JAX_FLOPS_BOUND:
        fail(f"the placed {name} step counts {f:.3f} x the JAX package's "
             "FLOPs a rank")
    if temp > dryrun.JAX_TEMP_BOUND:
        fail(f"the placed {name} step counts {temp:.3f} x the JAX "
             "package's temp bytes a rank")


def dist_counts(torch, dryrun):
    """The dry-run's counts of DIST_ARCH's TRAIN_BATCH x TRAIN_SEQ train
    step on a 1x1 mesh over a fake group, on meta tensors, and its memory
    counts (``dist_memory``) of that step, of the step at TRAIN_BATCH x
    TEMP_REMAT_SEQ with remat on and off, of the prefill of DIST_BATCH x
    DIST_PROMPT into DIST_SLOTS slots and of a decode step against
    them."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.distributed.sharding import local_bytes
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import tree_tensors
    cfg = model_config(DIST_ARCH)
    shape = InputShape(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", TRAIN_SEQ,
                       TRAIN_BATCH, "train")
    with dryrun.fake_process_group(1):
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        fn, args = dryrun.build_lowering(
            DIST_ARCH, "train_4k", mesh, cfg_override=cfg, shape=shape,
            donate=True)
        arg_bytes = local_bytes(args)
        _, counter = dryrun.count_step(fn, args)
        _, whole = dryrun.count_step(*dryrun.build_lowering(
            DIST_ARCH, "train_4k", mesh, cfg_override=cfg, shape=shape,
            place=False))
        memory = {"train": dist_memory(counter)}
        long = InputShape(f"train_{TRAIN_BATCH}x{TEMP_REMAT_SEQ}",
                          TEMP_REMAT_SEQ, TRAIN_BATCH, "train")
        for name, cfg_i, shp, kw in (
                ("remat on", cfg, long, {}),
                ("remat off", cfg.replace(remat=False), long, {}),
                ("prefill", cfg, dist_shape("prefill"),
                 {"max_len": DIST_SLOTS}),
                ("decode", cfg, dist_shape("decode"), {})):
            _, c = dryrun.count_step(*dryrun.build_lowering(
                DIST_ARCH, shp.name, mesh, cfg_override=cfg_i, shape=shp,
                donate=True, **kw))
            memory[name] = dist_memory(c)
    return {"argument_size_bytes": arg_bytes, "flops": counter.flops,
            "flops_global": whole.flops,
            "collective_bytes": counter.collective_bytes()["total"],
            "memory": memory,
            "leaves": len(list(tree_tensors(args)))}


def dist_memory(counter):
    """A settled ``StepCounter``'s memory counts."""
    return {"temp": counter.temp_bytes, "new_outputs":
            counter.new_output_bytes, "peak": counter.peak_bytes}


def dist_shape(kind):
    """(d)'s shapes: the prefill of DIST_BATCH x DIST_PROMPT tokens, and a
    decode step against DIST_SLOTS slots."""
    from repro_torch.configs.shapes import InputShape
    if kind == "prefill":
        return InputShape(f"prefill_{DIST_BATCH}x{DIST_PROMPT}", DIST_PROMPT,
                          DIST_BATCH, "prefill")
    return InputShape(f"decode_{DIST_BATCH}x{DIST_SLOTS}", DIST_SLOTS,
                      DIST_BATCH, "decode")


def card_memory(torch, dryrun, fn, args):
    """``fn(*args)`` run once on the card under the dry-run's counter:
    (its output, the settled counter, the rise of the allocator's
    requested bytes' peak over the bytes requested just before, and the
    same of its allocated bytes, which round each block up). Garbage is
    collected first, so none of it is freed inside the step."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = torch.cuda.memory_stats()
    before = {k: stats[f"{k}_bytes.all.current"]
              for k in ("requested", "allocated")}
    out, counter = dryrun.count_step(fn, args)
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    rise = {k: stats[f"{k}_bytes.all.peak"] - v for k, v in before.items()}
    return out, counter, rise


def hold_temp(part, name, dry, counter, reading):
    """Fail unless the card's requested-bytes rise (``card_memory``) lies
    between the dry-run's temp bytes and those plus its new outputs, and
    equals the counter's peak on the card, each within TEMP_SLACK of the
    rise. Returns the rise."""
    rise = reading["requested"]
    slack = TEMP_SLACK * rise
    say(f"  ({part}) {name}: requested bytes' peak rose {rise} B "
        f"(allocated bytes' {reading['allocated']} B); dry-run "
        f"temp_size_bytes {dry['temp']} B, new outputs "
        f"{dry['new_outputs']} B (bounds {dry['temp'] - slack:.0f} .. "
        f"{dry['temp'] + dry['new_outputs'] + slack:.0f}); the counter on "
        f"the card: peak {counter.peak_bytes} B, temp {counter.temp_bytes} "
        f"B, new outputs {counter.new_output_bytes} B; card: {card_line()}")
    if not dry["temp"] - slack <= rise <= (dry["temp"] + dry["new_outputs"]
                                           + slack):
        fail(f"{name}: the requested bytes' rise {rise} B lies outside the "
             f"dry-run's temp_size_bytes {dry['temp']} B (+ new outputs "
             f"{dry['new_outputs']} B) by more than {TEMP_SLACK:.0%}")
    if abs(counter.peak_bytes - rise) > slack:
        fail(f"{name}: the counter's peak on the card {counter.peak_bytes} "
             f"B is not the requested bytes' rise {rise} B within "
             f"{TEMP_SLACK:.0%}")
    return rise


def dist_batch(torch, dev, cfg):
    from repro_torch.data import synthetic_token_batches
    from repro_torch.training.train_loop import to_device
    return to_device(next(synthetic_token_batches(
        cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)), dev)


def placed_train_step(torch, dev, mesh, counts):
    """Phase 8 (b) and (c); see ``dist_phase``."""
    import numpy as np
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import (batch_pspec, param_pspecs,
                                         with_sharding)
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model, tree_tensors
    from repro_torch.models.common import init_shapes
    from repro_torch.training import init_adamw, make_train_step
    cfg = model_config(DIST_ARCH)
    model = build_model(cfg)
    step = make_train_step(model)
    batch = dist_batch(torch, dev, cfg)

    def init():
        return model.init(torch.Generator(device=dev).manual_seed(0))

    # the plain step under FlopCounterMode, which decomposes some ops it
    # has no formula for (rounding them otherwise), then the plain step
    params = init()
    with FlopCounterMode(display=False) as fc:
        step(params, init_adamw(params), batch)
    card_flops = fc.get_total_flops()
    del params
    params = init()
    params, opt, m = step(params, init_adamw(params), batch)
    torch.cuda.synchronize()
    plain = [t.detach().to("cpu") for t in tree_tensors((params, opt, m))]
    del params, opt, m
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    r0 = torch.cuda.memory_stats()["requested_bytes.all.current"]
    p_specs = param_pspecs(init_shapes(model), mesh)
    params = with_sharding(init(), p_specs, mesh)
    opt0 = init_adamw(params)
    opt = with_sharding(opt0, dryrun.param_pspecs_like_opt(opt0, p_specs),
                        mesh)
    del opt0
    pbatch = {k: with_sharding(v, batch_pspec(mesh, TRAIN_BATCH), mesh)
              for k, v in batch.items()}
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - m0
    asked = torch.cuda.memory_stats()["requested_bytes.all.current"] - r0
    want = counts["argument_size_bytes"]
    say(f"  (c) placed params, AdamW state and batch: the allocator's "
        f"requested bytes rose {asked} B, torch.cuda.memory_allocated() "
        f"{rise} B; the dry-run's argument_size_bytes {want} "
        f"({counts['leaves']} leaves; allocated may exceed it by under "
        f"{ALLOC_SLACK} B a leaf)")
    if asked != want or not want <= rise < want + ALLOC_SLACK * counts[
            "leaves"]:
        fail("the dry-run's argument bytes are not the bytes placed")

    def placed_step(*a):
        with implicit_replication():
            return step(*a)

    (params, opt, pm), counter, reading0 = card_memory(
        torch, dryrun, placed_step, (params, opt, pbatch))
    from torch.distributed.tensor import DTensor
    got = [t.to_local() if isinstance(t, DTensor) else t
           for t in tree_tensors((params, opt, pm))]
    same = [torch.equal(a.to(dev), b) for a, b in zip(plain, got)]
    say(f"  (b) {DIST_ARCH} train step {TRAIN_BATCH} x {TRAIN_SEQ}, placed "
        f"on 1x1 vs plain: loss {float(pm['loss'].full_tensor()):.6f} vs "
        f"{float(plain[-3]):.6f}, grad norm "
        f"{float(pm['grad_norm'].full_tensor()):.6f} vs "
        f"{float(plain[-2]):.6f}; {sum(same)} of {len(same)} leaves and "
        "metrics equal (torch.equal)")
    if len(got) != len(plain) or not all(same):
        fail("the placed train step differs from the plain step")
    say(f"  (c) FLOPs: dry-run flops {counts['flops']:.6e} (global "
        f"{counts['flops_global']:.6e}); FlopCounterMode on the plain step "
        f"{card_flops:.6e}; StepCounter on the placed step "
        f"{counter.flops:.6e}; collective bytes: dry-run "
        f"{counts['collective_bytes']}, card "
        f"{counter.collective_bytes()['total']}")
    if not counts["flops"] == counts["flops_global"] == card_flops \
            == counter.flops:
        fail("the dry-run's FLOPs are not the card's")
    if counts["collective_bytes"] or counter.collective_bytes()["total"]:
        fail("collective bytes on a 1x1 mesh")
    del got, plain
    # the step again, TEMP_RUNS times in all, then at TEMP_REMAT_SEQ with
    # remat on and off
    dry = counts["memory"]
    rises = [hold_temp("c", f"train step, remat on, run 1 of {TEMP_RUNS}",
                       dry["train"], counter, reading0)]
    for i in range(1, TEMP_RUNS):
        (params, opt, pm), counter, r = card_memory(
            torch, dryrun, placed_step, (params, opt, pbatch))
        rises.append(hold_temp(
            "c", f"train step, remat on, run {i + 1} of {TEMP_RUNS}",
            dry["train"], counter, r))
    say(f"  (c) the requested bytes' peak rise over {TEMP_RUNS} runs: "
        f"{rises} B, spread {max(rises) - min(rises)} B; card: "
        f"{card_line()}")
    del pbatch
    long = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TEMP_REMAT_SEQ + 1),
        dtype=np.int32)).to(dev)
    pbatch = {k: with_sharding(v, batch_pspec(mesh, TRAIN_BATCH), mesh)
              for k, v in (("tokens", long[:, :-1]), ("labels", long[:, 1:]))}
    remat_rise = {}
    for name, remat in (("remat on", True), ("remat off", False)):
        step_r = make_train_step(build_model(cfg.replace(remat=remat)))

        def placed_step_r(*a):
            with implicit_replication():
                return step_r(*a)

        (params, opt, pm), counter, r = card_memory(
            torch, dryrun, placed_step_r, (params, opt, pbatch))
        remat_rise[name] = hold_temp(
            "c", f"train step {TRAIN_BATCH} x {TEMP_REMAT_SEQ}, {name}",
            dry[name], counter, r)
    say(f"  (c) remat on against off at {TRAIN_BATCH} x {TEMP_REMAT_SEQ}: "
        f"dry-run temp_size_bytes {dry['remat on']['temp']} < "
        f"{dry['remat off']['temp']} B, the card's rise "
        f"{remat_rise['remat on']} < {remat_rise['remat off']} B; card: "
        f"{card_line()}")
    if not (dry["remat on"]["temp"] < dry["remat off"]["temp"]
            and remat_rise["remat on"] < remat_rise["remat off"]):
        fail("remat did not lower the dry-run's temp_size_bytes and the "
             "card's requested bytes' rise")
    del params, opt, pm, pbatch
    torch.cuda.empty_cache()


def placed_decode(torch, dev, mesh, counts):
    """Phase 8 (d); see ``dist_phase``."""
    import numpy as np
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import (PSpec, batch_pspec, cache_pspecs,
                                         param_pspecs, with_sharding)
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model, tree_tensors
    cfg = model_config(DIST_ARCH)
    model = build_model(cfg)
    B, S = DIST_BATCH, DIST_PROMPT
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, S + DIST_STEPS), dtype=np.int32)).to(dev)

    def run(params, cache, place):
        out = []
        with torch.no_grad(), implicit_replication():
            lg, pre = model.prefill(params, place(toks[:, :S],
                                                  PSpec(None, None)),
                                    max_len=DIST_SLOTS)
            out.append(lg)
            for dst, src in zip(tree_tensors(cache), tree_tensors(pre)):
                dst.copy_(src)
            del pre
            for i in range(DIST_STEPS):
                lg, cache = model.decode_step(
                    params, place(toks[:, S + i:S + i + 1], PSpec(None, None)),
                    cache, place(torch.full((B,), S + i, dtype=torch.int32,
                                            device=dev), PSpec(None)))
                out.append(lg)
        return [t.full_tensor() if hasattr(t, "full_tensor") else t
                for t in out]

    def init():
        return model.init(torch.Generator(device=dev).manual_seed(0))

    plain = run(init(), model.init_cache(B, DIST_SLOTS, device=dev),
                lambda t, s: t)
    params, cache = init(), model.init_cache(B, DIST_SLOTS, device=dev)
    placed = run(with_sharding(params, param_pspecs(params, mesh), mesh),
                 with_sharding(cache, cache_pspecs(cache, mesh, B), mesh),
                 lambda t, s: with_sharding(t, s, mesh))
    same = [torch.equal(a, b) for a, b in zip(placed, plain)]
    say(f"  (d) prefill of {B} x {S} and {DIST_STEPS} decode steps through "
        f"a {DIST_SLOTS}-slot cache, placed vs plain: {sum(same)} of "
        f"{len(same)} logits equal (torch.equal)")
    if len(same) != 1 + DIST_STEPS or not all(same):
        fail("placed prefill or decode logits differ from the plain path's")
    del params, cache, placed, plain
    torch.cuda.empty_cache()

    # the dry-run's prefill and decode step, on inputs placed as it places
    # them
    dry = counts["memory"]
    fns = {kind: dryrun.build_lowering(
        DIST_ARCH, kind, mesh, cfg_override=cfg, shape=dist_shape(kind),
        max_len=DIST_SLOTS, donate=True)[0]
        for kind in ("prefill", "decode")}
    params = init()
    params = with_sharding(params, param_pspecs(params, mesh), mesh)
    tokens = with_sharding(toks[:, :S], batch_pspec(mesh, B, extra_dims=1),
                           mesh)
    (_, pre), counter, reading = card_memory(
        torch, dryrun, fns["prefill"], (params, {"tokens": tokens}))
    hold_temp("d", f"prefill of {B} x {S} into {DIST_SLOTS} slots",
              dry["prefill"], counter, reading)
    cache = model.init_cache(B, DIST_SLOTS, device=dev)
    cache = with_sharding(cache, cache_pspecs(cache, mesh, B), mesh)
    with torch.no_grad():
        for dst, src in zip(tree_tensors(cache), tree_tensors(pre)):
            dst.copy_(src)
    del pre
    token = with_sharding(toks[:, S:S + 1], batch_pspec(mesh, B,
                                                        extra_dims=1), mesh)
    pos = with_sharding(torch.full((B,), S, dtype=torch.int32, device=dev),
                        batch_pspec(mesh, B, extra_dims=0), mesh)
    _, counter, reading = card_memory(torch, dryrun, fns["decode"],
                                      (params, token, cache, pos))
    hold_temp("d", f"decode step of {B} rows against {DIST_SLOTS} slots",
              dry["decode"], counter, reading)
    del params, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the capacity dispatch and the chunked reference attention
# ---------------------------------------------------------------------------

def capacity_phase(torch, dev):
    """Phase 9; see the module's docstring. Returns each serve run's launch
    counts under its key in CAPACITY_RUNS."""
    import torch.distributed as dist
    from repro_torch.energy import H100
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import TorchBackend
    t0 = time.perf_counter()
    counts = {}
    for name, run in zip(CAPACITY_MODELS, CAPACITY_RUNS):
        cfg = model_config(name).replace(moe_dispatch="capacity")
        t1 = time.perf_counter()
        backend = TorchBackend(cfg, H100, max_batch=8, cache_len=2048,
                               device=dev)
        torch.cuda.synchronize()
        say(f"  (a) {name} capacity dispatch (factor "
            f"{cfg.capacity_factor}), {cfg.dtype} at {cfg.num_layers} "
            f"layers: backend ready in {time.perf_counter() - t1:.1f} s; "
            f"{len(backend.graphs)} graphs, a decode replay launches "
            f"{backend.decode_graph.launches}")
        check_graphs(torch, dev, backend)
        dropped_share(torch, dev, backend)
        counts[run] = serve(torch, backend, "agft", normal_requests(),
                            sampling_period_s=0.2)
        say(f"  (a) {name} graphed decode step, median under AGFT: capacity "
            f"{STEP_MS[(name, 'capacity')]:.4f} ms, dense (phase 4) "
            f"{STEP_MS.get((name, 'dense'), float('nan')):.4f} ms; card: "
            f"{card_line()}")
        del backend
        torch.cuda.empty_cache()
    variant_dryrun()
    before = launch_counts()
    memory = capacity_counts()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        placed_capacity_step(torch, dev, mesh, memory["train"])
        placed_chunked_prefill(torch, dev, mesh, memory["prefill"])
    finally:
        dist.destroy_process_group()
    if launch_counts() != before:
        fail(f"phase 9 (b) launched port kernels: {before} -> "
             f"{launch_counts()}")
    say(f"  phase 9: {time.perf_counter() - t0:.1f} s wall")
    return counts


def variant_dryrun():
    """Phase 9 (c): the port's ``cost_extrapolated`` of VARIANT (the
    capacity dispatch with the expert-parallel constraint: the config
    fields its golden row records) on the 16x16
    production mesh over a fake group, on this machine's torch, held to the
    JAX package's (VARIANT_GOLDEN) as ``tests/test_torch_variants.py``
    holds it: FLOPs a rank within ``dryrun.JAX_FLOPS_BOUND`` x, collective
    bytes within 2 x, ``u2_temp_bytes`` within ``dryrun.JAX_TEMP_BOUND`` x,
    and the FLOPs an even split of the whole step's within
    ``dryrun.JAX_FLOPS_BOUND``; its collective bytes, by kind, equal to the
    byte the CPU's (VARIANT_PINNED), none issued by DTensor's own dispatch.
    Prints the table of them by site (``tools/dryrun_sites.py``'s) first."""
    import torch
    from repro_torch.launch import dryrun
    arch, shape, variant = VARIANT
    with open(VARIANT_PINNED) as f:
        pinned = next(r["collective_bytes"] for r in json.load(f)["rows"]
                      if (r["arch"], r["shape"], r["variant"], r["mesh"])
                      == VARIANT + ("16x16",))
    with open(VARIANT_GOLDEN) as f:
        ref = next(r for r in json.load(f)["results"]
                   if (r["arch"], r["shape"], r["variant"]) == VARIANT)
    fields, ref = ref["replace"], ref["extrapolated"]
    t0 = time.perf_counter()
    got = dryrun.cost_extrapolated(arch, shape, (16, 16),
                                   lambda c: c.replace(**fields))
    # the table ``tools/dryrun_sites.py --side port`` prints
    say(f"  (c) collective bytes by site, torch {torch.__version__}:\n"
        + dryrun.sites_table(got["collective_sites"]))
    own = sum(r[-1] for r in got["collective_sites"]
              if r[3].startswith(dryrun.DTENSOR_SITE))
    if got["collective_bytes"] != pinned or own:
        fail(f"{arch} x {shape} x {variant}: collective bytes "
             f"{got['collective_bytes']} on torch {torch.__version__}, the "
             f"CPU's {pinned}; {own} B from DTensor's own dispatch")
    say(f"  (c) collective bytes by kind equal the CPU's to the byte on "
        f"torch {torch.__version__}: {got['collective_bytes']}")
    ratios = {"flops": got["flops"] / ref["flops"],
              "collective bytes": got["collective_bytes"]["total"]
              / ref["collective_bytes"]["total"],
              "u2 temp bytes": got["u2_temp_bytes"] / ref["u2_temp_bytes"],
              "flops x 256 / flops_global": got["flops"] * 256
              / got["flops_global"]}
    say(f"  (c) dry-run {arch} x {shape} x 16x16, {variant}: flops a rank "
        f"{got['flops']:.4e} (global {got['flops_global']:.4e}), collective "
        f"bytes {got['collective_bytes']['total']:.4e}, u2 temp bytes "
        f"{got['u2_temp_bytes']:.4e}; over the JAX package's: "
        + ", ".join(f"{k} {v:.4f}" for k, v in ratios.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    bounds = {"flops": dryrun.JAX_FLOPS_BOUND, "collective bytes": 2.0,
              "u2 temp bytes": dryrun.JAX_TEMP_BOUND,
              "flops x 256 / flops_global": dryrun.JAX_FLOPS_BOUND}
    over = [k for k, v in ratios.items() if v > bounds[k]]
    if over or ratios["flops x 256 / flops_global"] < 1:
        fail(f"{arch} x {shape} x {variant}: over the bounds {over} "
             f"({ratios})")


def dropped_share(torch, dev, backend):
    """The share of assignments the capacity dispatch drops, over the
    layers of one eager decode step of ``max_batch`` rows at context 600
    and of a 64-token forward, on the backend's weights (its cache
    cloned)."""
    from repro_torch.models import blocks, tree_clone
    kept = []
    plain = blocks.capacity_experts

    def recorded(*args):
        y, keep = plain(*args)
        kept.append(keep)
        return y, keep

    cfg, B = backend.cfg, backend.max_batch
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                         device=dev)
    blocks.capacity_experts = recorded
    try:
        with torch.no_grad():
            backend.model.decode_step(
                backend.params, toks, tree_clone(backend.cache),
                torch.full((B,), 600, dtype=torch.long, device=dev))
            step = [float(k.float().mean()) for k in kept]
            kept.clear()
            backend.model.forward(backend.params, torch.randint(
                0, cfg.vocab_size, (1, 64), generator=gen, device=dev))
            fwd = [float(k.float().mean()) for k in kept]
    finally:
        blocks.capacity_experts = plain
    for what, shares, n in (("decode step", step, B), ("64-token forward",
                                                       fwd, 64)):
        C = blocks.moe_capacity(cfg, n)
        say(f"  (a) {cfg.name} {what}: C = {C} rows an expert "
            f"({n} tokens x top-{cfg.top_k} over {cfg.num_experts} "
            f"experts x {cfg.capacity_factor}); assignments dropped, mean "
            f"over {len(shares)} MoE layers: "
            f"{1 - sum(shares) / max(len(shares), 1):.4f} (min "
            f"{1 - max(shares):.4f}, max {1 - min(shares):.4f})")
        if len(shares) != len(backend.params["layers"]):
            fail(f"{cfg.name} {what}: the capacity dispatch ran in "
                 f"{len(shares)} layers, not every MoE layer")


def capacity_counts():
    """The dry-run's memory counts (``dist_memory``), on a 1x1 mesh over a
    fake group, of phase 9 (b)'s steps: CAP_ARCH's capacity train step at
    TRAIN_BATCH x TRAIN_SEQ (the donated form the card runs), and the
    chunked prefill of CHUNK_BATCH x CHUNK_SEQ."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    out = {}
    with dryrun.fake_process_group(1):
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        for kind, (arch, cfg, shape) in capacity_steps().items():
            _, c = dryrun.count_step(*dryrun.build_lowering(
                arch, shape.name, mesh, cfg_override=cfg, shape=shape,
                donate=True))
            out[kind] = dist_memory(c)
    return out


def capacity_steps():
    """Phase 9 (b)'s steps: kind -> (arch, config, InputShape)."""
    from repro_torch.configs.shapes import InputShape
    cap = model_config(CAP_ARCH).replace(
        moe_dispatch="capacity", num_layers=CAP_TRAIN_LAYERS,
        use_pallas=False)
    chunk = model_config(CHUNK_ARCH).replace(ref_attention="chunked",
                                             use_pallas=False)
    return {"train": (CAP_ARCH, cap, InputShape(
                f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH,
                "train")),
            "prefill": (CHUNK_ARCH, chunk, InputShape(
                f"prefill_{CHUNK_BATCH}x{CHUNK_SEQ}", CHUNK_SEQ,
                CHUNK_BATCH, "prefill"))}


def placed_capacity_step(torch, dev, mesh, dry):
    """Phase 9 (b): CAP_ARCH's capacity train step placed on ``mesh`` (1x1)
    against the plain step, bit for bit, and its temp bytes against the
    card (``hold_temp``)."""
    from repro_torch.distributed import (batch_pspec, param_pspecs,
                                         with_sharding)
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model, tree_tensors
    from repro_torch.training import init_adamw, make_train_step
    from torch.distributed.tensor import DTensor
    arch, cfg, shape = capacity_steps()["train"]
    model = build_model(cfg)
    batch = dist_batch(torch, dev, cfg)

    def init():
        return model.init(torch.Generator(device=dev).manual_seed(0))

    params = init()
    params, opt, m = make_train_step(model)(params, init_adamw(params), batch)
    torch.cuda.synchronize()
    plain = [t.detach().to("cpu") for t in tree_tensors((params, opt, m))]
    n_params = sum(t.numel() for t in tree_tensors(params))
    del params, opt, m
    torch.cuda.empty_cache()
    fn, _ = dryrun.build_lowering(arch, shape.name, mesh, cfg_override=cfg,
                                  shape=shape, donate=True)
    params = init()
    p_specs = param_pspecs(params, mesh)
    opt = init_adamw(params)
    args = (with_sharding(params, p_specs, mesh),
            with_sharding(opt, dryrun.param_pspecs_like_opt(opt, p_specs),
                          mesh),
            {k: with_sharding(v, batch_pspec(mesh, TRAIN_BATCH), mesh)
             for k, v in batch.items()})
    del params, opt
    out, counter, reading = card_memory(torch, dryrun, fn, args)
    got = [t.to_local() if isinstance(t, DTensor) else t
           for t in tree_tensors(out)]
    same = [torch.equal(a.to(dev), b) for a, b in zip(plain, got)]
    say(f"  (b) {arch} capacity train step ({CAP_TRAIN_LAYERS} layers, "
        f"{n_params / 1e9:.3f} B params, {cfg.dtype}) {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, "
        f"placed on 1x1 vs plain: loss {float(plain[-3]):.6f}; "
        f"{sum(same)} of {len(same)} leaves and metrics equal "
        "(torch.equal)")
    if len(got) != len(plain) or not all(same):
        fail("the placed capacity train step differs from the plain step")
    hold_temp("b", f"{arch} capacity train step", dry, counter, reading)
    del out, got, args, plain
    torch.cuda.empty_cache()


def placed_chunked_prefill(torch, dev, mesh, dry):
    """Phase 9 (b): CHUNK_ARCH's prefill through the chunked reference
    attention placed on ``mesh`` (1x1) against the plain prefill, bit for
    bit (logits and every cache tensor), and its temp bytes against the
    card."""
    import numpy as np
    from repro_torch.distributed import (batch_pspec, param_pspecs,
                                         with_sharding)
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model, tree_tensors
    arch, cfg, shape = capacity_steps()["prefill"]
    model = build_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (CHUNK_BATCH, CHUNK_SEQ), dtype=np.int32)).to(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        plain = [t.to("cpu") for t in tree_tensors(
            model.prefill(params, toks, max_len=CHUNK_SEQ))]
    fn, _ = dryrun.build_lowering(arch, shape.name, mesh, cfg_override=cfg,
                                  shape=shape)
    args = (with_sharding(params, param_pspecs(params, mesh), mesh),
            {"tokens": with_sharding(toks, batch_pspec(mesh, CHUNK_BATCH),
                                     mesh)})
    out, counter, reading = card_memory(torch, dryrun, fn, args)
    got = [t.full_tensor() for t in tree_tensors(out)]
    same = [torch.equal(a.to(dev), b) for a, b in zip(plain, got)]
    say(f"  (b) {arch} prefill of {CHUNK_BATCH} x {CHUNK_SEQ} through the "
        f"chunked reference attention, placed on 1x1 vs plain: {sum(same)} "
        f"of {len(same)} tensors (logits, cache) equal (torch.equal)")
    if len(got) != len(plain) or not all(same):
        fail("the placed chunked prefill differs from the plain prefill")
    hold_temp("b", f"{arch} chunked prefill", dry, counter, reading)
    del out, got, args, params, plain
    torch.cuda.empty_cache()


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

    say("== phase 6: whisper-medium (encoder-decoder) through its model "
        "contract")
    counts[WHISPER] = serve_whisper(torch, dev)
    torch.cuda.empty_cache()

    say("== phase 7: training: fp32 gradients vs fp64, full-depth "
        f"{TRAIN_ARCH} trained, its checkpoint and its weights served")
    counts[TRAINED_RUN] = train_phase(torch, dev)
    torch.cuda.empty_cache()

    say("== phase 8: the distribution layer: the dry-run, and full-width "
        f"{DIST_ARCH} placed on a 1x1 mesh against the plain path")
    dist_phase(torch, dev)
    torch.cuda.empty_cache()

    say("== phase 9: the capacity MoE dispatch served, and the capacity "
        "train step and a chunked prefill placed on a 1x1 mesh")
    counts.update(capacity_phase(torch, dev))
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
