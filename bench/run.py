"""Run one cell of the benchmark once:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the NVIDIA cards the cell
asks for. Set-up: the kernels built into (or loaded from) the checkout's
``build/kernels``, the weights drawn on the card from the seed and handed
to ``TorchBackend`` (which captures the decode step and one forward per
prefill bucket as CUDA graphs) and later to the reference, the engine and
a fresh power policy, then the mix's warm-up iterations. Window: the
traffic through ``InferenceEngine`` for ``--seconds`` of wall time. Then
the comparison that decides ``correct`` (``check.py``), and one JSON line
on standard output, the numbers compared also on standard error.

``--trace 1`` traces a slice of the window with ``torch.profiler`` and
prints the per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def setup_env(root: Path = ROOT) -> None:
    """Every cache of the program's builds at a fixed path inside the
    checkout; the port's package on the path."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(root / "build" / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    v = sorted(values)
    k = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


class RunData:
    """What a per-layer metric's reader reads: the cell, the window's
    iterations and requests, the backend's graphs' launch counts and, in a
    traced run, the slice (``traced``)."""

    def __init__(self, cell, loop, backend, traced):
        self.loop, self.traced = loop, traced
        self.config = cell.config
        self.model = cell.model
        self.max_batch = backend.max_batch
        self.iterations = loop.window_iterations()
        self.all_iterations = loop.rec.iterations
        self.decode_walls = backend.decode_wall_s[loop.decode_walls0:]
        self.decode_launches = dict(backend.decode_graph.launches)
        self.prefill_launches = {n: dict(g.launches)
                                 for n, g in backend.prefill_graphs.items()}


def end_to_end(loop, setup_s: float) -> dict:
    eng = loop.engine
    c = eng.metrics.c
    tok0, e0, _ = loop.counters0
    tokens = c.generation_tokens_total - tok0
    wall = loop.wall1 - loop.wall0
    out = {"setup_s": setup_s,
           "energy_per_token": (c.energy_joules_total - e0) / max(tokens, 1),
           "itl_p95": 1e3 * percentile(loop.gaps, 95) if loop.gaps
           else float("nan"),
           "itl_p99": 1e3 * percentile(loop.gaps, 99) if loop.gaps
           else float("nan"),
           "output_tokens_per_s": tokens / wall}
    reqs = loop.window_requests()
    ttft = [(r.first_token_time if r.first_token_time is not None
             else loop.clock1) - r.arrival_time for r in reqs]
    out["ttft_p95"] = 1e3 * percentile(ttft, 95) if ttft else float("nan")
    return out


def tokens_miscounted(loop) -> int:
    """The engine's tokens and finished requests in the window against the
    harness's counts, and every finished request's tokens against its
    output length."""
    c = loop.engine.metrics.c
    tok0, _, fin0 = loop.counters0
    mine = sum(it.tokens for it in loop.window_iterations())
    fin_mine = sum(1 for r in loop.engine.finished
                   if r.finish_time is not None
                   and loop.clock0 < r.finish_time <= loop.clock1)
    bad = abs(c.generation_tokens_total - tok0 - mine)
    bad += abs(c.requests_finished_total - fin0 - fin_mine)
    bad += sum(abs(loop.tokens_of.get(r.request_id, 0) - r.output_len)
               for r in loop.engine.finished)
    return bad


def build(cell, seed: int, dev):
    """The weights drawn from ``seed`` on ``dev`` and the backend over
    them (its graphs captured): (backend, params)."""
    import torch

    from repro_torch.energy import H100
    from repro_torch.models.common import ModelConfig
    from repro_torch.serving import TorchBackend

    mix = cell.traffic
    mc = ModelConfig(**cell.config["model_config"])
    gen = torch.Generator(device=dev).manual_seed(seed % 2**63)
    params = cell.model.make_weights(cell.config, gen, dev)
    backend = TorchBackend(mc, H100, max_batch=mix["max_batch"],
                           cache_len=mix["cache_len"], device=dev,
                           params=params)
    return backend, params


def serve_window(cell, backend, seed: int, seconds: float, tracer=None,
                 t_start: Optional[float] = None):
    """The engine, a fresh policy and the seed's traffic over ``backend``
    from a zeroed cache: the warm-up, then the window. Returns the loop
    and the set-up time (from ``t_start`` to the window's opening)."""
    import torch

    from bench import serve, traffic
    from repro_torch.energy import H100
    from repro_torch.models.common import ModelConfig, tree_tensors
    from repro_torch.policies import get_policy
    from repro_torch.serving import EngineConfig, InferenceEngine

    mix = cell.traffic
    mc = ModelConfig(**cell.config["model_config"])
    rec = serve.Recorder(backend)
    engine = InferenceEngine(
        mc, EngineConfig(max_num_seqs=mix["max_batch"],
                         num_kv_blocks=mix["num_kv_blocks"]),
        hardware=H100, backend=rec)
    policy = get_policy(mix["policy"], H100, **mix.get("policy_args", {}))
    for t in tree_tensors(backend.cache):
        t.zero_()
    loop = serve.Loop(engine, policy, rec, traffic.jobs(mix, seed), mix,
                      mix.get("template_frac", 0.9))
    loop.warmup(mix["warmup_iterations"])
    if backend.device.type == "cuda":
        torch.cuda.synchronize(backend.device)
    setup_s = time.perf_counter() - (t_start if t_start is not None
                                     else time.perf_counter())
    loop.window(seconds, tracer)
    if backend.device.type == "cuda":
        torch.cuda.synchronize(backend.device)
    return loop, setup_s


def outputs(loop, backend):
    """What the timed path left, for the comparison: the decode steps'
    slots (T, B), each layer's cache leaves, the last decode step's logits
    (B, V) and each stashed prefill forward's logits (n, V)."""
    import numpy as np
    import torch

    rec = loop.rec
    pos = torch.as_tensor(np.stack(rec.pos), device=backend.device)
    logits = rec.logits.reshape(rec.logits.shape[0], -1).clone()
    prefill = {n: t.reshape(n, -1) for n, t in rec.prefill_out.items()}
    return pos, logits, prefill


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cell=None, t_start: float = T_START,
             prepare=None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``cell`` (a loaded ``bench.cell.Cell``) may stand in for the
    manifest's, as the CPU tests' small ones do; ``prepare(backend)`` is
    called once the backend is built."""
    import gc

    import torch

    from bench import check
    from bench.cell import load_cell, readers
    from bench.trace import Tracer

    cell = cell or load_cell(name)
    dev = torch.device(device)
    backend, params = build(cell, seed, dev)
    if prepare is not None:
        prepare(backend)
    tracer = Tracer() if trace else None
    loop, setup_s = serve_window(cell, backend, seed, seconds, tracer,
                                 t_start)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    e2e = end_to_end(loop, setup_s)
    layer = {}
    if trace:
        tracer.read()
    data = RunData(cell, loop, backend, tracer.result if trace else None)
    for mname, reader in readers(cell).items():
        v = reader.read(data)
        if v is not None:
            layer[mname] = v
    del data
    pos, logits, prefill = outputs(loop, backend)
    cache = backend.cache
    # the graphs' memory freed before the reference; the cache and the
    # weights kept
    backend.decode_graph = backend.prefill_graphs = None
    loop.rec.inner = None
    del backend
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.model_numbers(
        cell.model, cell.config, params, pos,
        list(cell.model.program_cache_layers(cache)), logits, prefill)
    numbers["tokens_miscounted"] = tokens_miscounted(loop)
    ok, lines = check.verdict(numbers, cell.limits)
    _say(f"reference check: {time.perf_counter() - t_check:.1f} s over "
         f"{pos.shape[0]} decode steps and {len(prefill)} prefill buckets")
    eng = loop.engine
    units = {m["name"]: m["unit"]
             for m in cell.end_to_end + cell.per_layer}
    chosen = layer if trace else {m["name"]: e2e[m["name"]]
                                  for m in cell.end_to_end}
    result = {
        "correct": bool(ok),
        "attempted": len(loop.window_requests()),
        "failed": sum(1 for r in eng.sched.dropped
                      if loop.clock0 <= r.arrival_time <= loop.clock1),
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in chosen.items()},
        "device": device_info(dev, peak),
    }
    if trace and tracer.result is not None:
        result["device"]["busy_s"] = tracer.result.busy_s
        result["device"]["window_s"] = tracer.result.window_s
        result["breakdown"] = {"device_ops": tracer.result.ops,
                               "idle_gaps": tracer.result.idle}
    result["info"] = {
        "seed": seed,
        "window_s": loop.wall1 - loop.wall0,
        "engine_s": loop.clock1 - loop.clock0,
        "iterations": len(loop.window_iterations()),
        "decode_steps": int(pos.shape[0]),
        "finished": sum(1 for r in eng.finished
                        if loop.clock0 < r.finish_time <= loop.clock1),
        "waiting_at_end": len(eng.sched.waiting) + sum(
            1 for p in eng._pending if p[0] <= loop.clock1),
        "end_to_end": e2e if trace else None,
        "per_layer": None if trace else layer,
    }
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in lines}
    for k, v, lim in lines:
        _say(f"check {k} {v!r} limit {lim!r}")
    return result


def device_info(dev, peak: int) -> dict:
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak)}


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names, compared whole, among ``modules``
    (default: what this process has loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_env()
    import torch
    from bench.cell import load_cell
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _say(f"{args.workload} needs {cell.chips} CUDA device(s); "
             f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             " device(s)")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", cell=cell)
    bad = forbidden_modules()
    if bad:
        _say(f"the run loaded {bad}: the benchmark must not import JAX or "
             "the JAX package")
        return 3
    check_part = result.pop("check")
    result["check"] = check_part            # last key of the line
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
