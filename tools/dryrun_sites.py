#!/usr/bin/env python3
"""One (arch, shape, mesh)'s collective bytes by the site that issues them,
the port's beside the JAX package's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/dryrun_sites.py \\
        --arch deepseek-v2-lite-16b --shape train_4k --mesh 16x16 \\
        [--variant top1_router] [--side port|jax|both] [--memory] \\
        [--json OUT.json]

``--mesh`` is 16x16 or 2x16x16 (the production meshes) or 2x4 or 2x2x4
(the debug meshes); ``--variant`` one of ``tests/golden_variants_jax.json``'s
(its ``replace`` fields and donation).

The port's table (``--side port``; no JAX is imported): the dry-run's
(``repro_torch.launch.dryrun``, meta tensors over a ``fake`` group as wide
as the mesh) collective bytes of one rank by kind, dtype, phase (forward,
backward, or a checkpointed layer's recompute) and site, the innermost
frames of the port's placed ops that issued the collective; the rows whose
site begins "DTensor's own dispatch" are collectives that DTensor's
sharding propagation chose for an op whose placements the port does not
state. ``--memory`` adds the live bytes at the peak that sets
``temp_size_bytes``, by the site that allocated them.

The JAX package's table (``--side jax``, which imports ``repro``): the
collectives of its partitioned HLO, lowered and compiled on the CPU as
``repro.launch.dryrun.cost_extrapolated`` does it (the u = 1 and u = 2
unrolled variants, each count extrapolated linearly to the full depth), by
kind, dtype, result shape and the JAX source line the partitioner made it
for. It counts tuple-shaped results (``(bf16[..], ..) all-reduce(``) as
well, which ``repro.launch.dryrun.collective_bytes`` skips: the golden's
count and the full count are printed apart.

CPU counts of one rank, not speeds. A train step on a production mesh
takes about 20 s on the port's side and 10-60 s on the JAX package's
(recurrentgemma-9b's train and prefill, whose plain RG-LRU walks time token
by token, 5-15 minutes on the port's).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]

from repro_torch.configs import config_for_shape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

VARIANTS = os.path.join(HERE, "tests", "golden_variants_jax.json")
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def mesh_dims(name: str) -> tuple:
    return tuple(int(v) for v in name.split("x"))


def variant_of(arch: str, shape: str, variant):
    """(cfg_transform, donate) of ``variant`` (None: the plain step), from
    the JAX package's golden row of (arch, shape, variant)."""
    if variant is None:
        return None, False
    with open(VARIANTS) as f:
        rows = json.load(f)["results"]
    row = next((r for r in rows if r["variant"] == variant), None)
    if row is None:
        raise SystemExit(f"no variant {variant!r} in {VARIANTS}")
    fields = row["replace"]
    return (lambda c: c.replace(**fields)), row["donate"]


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------

class SitedCounter(dryrun.StepCounter):
    """A ``StepCounter`` that also keeps each allocation's site and size
    and the allocation count at which it was freed."""

    def __init__(self):
        super().__init__()
        self.alloc_sites = []           # [site, bytes, freed at] an alloc

    def _allocated(self, func, args, kwargs, out):
        first, prev = len(self.after), self.live_bytes
        super()._allocated(func, args, kwargs, out)
        site = f"{dryrun.collective_site(depth=3)[1]} ({func})"
        for i in range(first, len(self.after)):
            self.alloc_sites.append([site, self.after[i] - prev, None])
            prev = self.after[i]

    def _freer(self, key):
        plain = super()._freer(key)

        def freed(ref):
            i = self._live[key][0]
            plain(ref)
            self.alloc_sites[i][2] = len(self.after)
        return freed


def port_counts(arch: str, shape: str, mesh: str, variant=None,
                memory: bool = False, trace: bool = False) -> dict:
    """The port's dry-run of (arch, shape, mesh, variant), one rank:
    ``flops``, ``collective_bytes``, ``collective_sites`` (``StepCounter``'s
    rows), ``temp_bytes`` and, with ``memory``, ``peak_sites``: [site, bytes] of
    what is live at the temp peak, largest first. With ``trace`` (autograd's
    anomaly mode: slower) a backward collective that no frame of the port
    issued is put down to the forward op whose node issued it."""
    transform, donate = variant_of(arch, shape, variant)
    cfg = config_for_shape(arch, shape).replace(use_pallas=False)
    if transform is not None:
        cfg = transform(cfg)
    dims = mesh_dims(mesh)
    n = 1
    for v in dims:
        n *= v
    # a backward node then keeps the forward stack that made it
    anomaly = (torch.autograd.set_detect_anomaly(True, check_nan=False)
               if trace else contextlib.nullcontext())
    with dryrun.fake_process_group(n), anomaly:
        fn, args = dryrun.build_lowering(
            arch, shape, dryrun._mesh_for(dims), cfg_override=cfg,
            donate=donate)
        _, counter = dryrun.count_step(
            fn, args, SitedCounter() if memory else None)
    result = {"arch": arch, "shape": shape, "mesh": mesh,
              "variant": variant,
              "flops": counter.flops,
              "collective_bytes": counter.collective_bytes(),
              "collective_sites": counter.collective_sites(),
              "temp_bytes": counter.temp_bytes}
    if memory:
        result["peak_sites"] = _peak_sites(counter)
    return result


def _peak_sites(counter: SitedCounter) -> list:
    """[site, bytes] of the allocations live just after the one that sets
    ``temp_bytes`` (the step's outputs left out, as ``settle`` leaves
    them), summed by site, largest first."""
    peak, by_site = counter.temp_at, {}
    for i, (site, n, freed) in enumerate(counter.alloc_sites[:peak + 1]):
        if (freed is None or freed > peak) and i not in counter.output_allocs:
            by_site[site] = by_site.get(site, 0) + n
    return sorted(([s, n] for s, n in by_site.items()),
                  key=lambda r: -r[1])


# ---------------------------------------------------------------------------
# the JAX package
# ---------------------------------------------------------------------------

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(.*?)\s+"
                    r"(all-reduce|all-gather|reduce-scatter|all-to-all|"
                    r"collective-permute)(-start|-done)?\(")
_ARRAY = re.compile(r"([a-z][a-z0-9]*)\[([\d,]*)\]")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_FRAME_ID = re.compile(r"stack_frame_id=(\d+)")
_GOLDEN_LINE = re.compile(r"^%?[\w.\-]+ = ([a-z0-9]+)\[([\d,]*)\]")
_TABLE_ROW = re.compile(r'^(\d+) (?:"(.*)"|\{(.*)\})$')


def _frames(text: str):
    """The stack-frame tables of HLO ``text``: a function from a
    ``stack_frame_id`` to its frames, innermost first, each
    "file:line function" of a file under ``src/``."""
    tables, name = {}, None
    for line in text.splitlines():
        if line in ("FileNames", "FunctionNames", "FileLocations",
                    "StackFrames"):
            name = line
            tables[name] = {}
            continue
        m = _TABLE_ROW.match(line) if name else None
        if not m:
            name = None
            continue
        value = m.group(2) if m.group(2) is not None else dict(
            kv.split("=") for kv in m.group(3).split())
        tables[name][m.group(1)] = value
    src = os.path.join(HERE, "src") + os.sep

    def frames(fid):
        out = []
        while fid in tables.get("StackFrames", {}):
            frame = tables["StackFrames"][fid]
            loc = tables["FileLocations"][frame["file_location_id"]]
            path = tables["FileNames"][loc["file_name_id"]]
            if path.startswith(src):
                fn = tables["FunctionNames"][loc["function_name_id"]]
                out.append(f"{path[len(src):]}:{loc['line']} {fn}")
            # the caller's frame, one below the id printed (0: none)
            fid = str(int(frame["parent_frame_id"]) - 1)
        return out
    return frames


def hlo_collectives(text: str, depth: int = 2) -> dict:
    """(kind, dtype, shape, tuple, golden, promoted, where) -> bytes of each
    collective result in partitioned HLO ``text`` (an all-reduce counted
    twice, as the JAX package counts it). ``tuple``: the result is a tuple
    (collectives XLA combined); ``golden``: ``repro.launch.dryrun.
    collective_bytes`` counts it; ``promoted``: an all-reduce whose sum the
    CPU backend carries in f32 for a narrower program type (its reducer a
    ``*_promoted`` clone); ``where``: the op's name past ``jit(...)/`` and
    the ``depth`` innermost frames of ``src/`` it was made for."""
    from repro.launch.dryrun import _DTYPE_BYTES

    frames = _frames(text)
    out = {}
    for line in text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        result, kind = m.group(1), m.group(2)
        is_tuple = result.startswith("(")
        golden = bool(_GOLDEN_LINE.match(line.strip()))
        promoted = "_promoted," in line or line.rstrip().endswith(
            "_promoted")
        op = _OP_NAME.search(line)
        fid = _FRAME_ID.search(line)
        where = op.group(1).split("/", 1)[-1] if op else "(no op_name)"
        if fid:
            where += " @ " + " < ".join(frames(fid.group(1))[:depth])
        for dt, dims in _ARRAY.findall(result):
            n = _DTYPE_BYTES.get(dt, 4)
            for d in dims.split(","):
                if d:
                    n *= int(d)
            n *= 2 if kind == "all-reduce" else 1
            key = (kind, dt, f"[{dims}]", is_tuple, golden, promoted, where)
            out[key] = out.get(key, 0) + n
    return out


def jax_counts(arch: str, shape: str, mesh: str, variant=None) -> dict:
    """The JAX package's collectives of (arch, shape, mesh, variant),
    extrapolated to the full depth from the u = 1 and u = 2 unrolled
    variants as its ``cost_extrapolated`` does: ``golden`` (what its
    ``collective_bytes`` counts, by kind), ``full`` (tuple-shaped results
    too) and ``rows`` [kind, dtype, shape, tuple, golden, promoted, where,
    bytes] (``hlo_collectives``'s keys)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from repro.launch import dryrun as jdry   # sets 512 host devices
    from repro.configs import config_for_shape as jax_config
    from repro.launch.mesh import make_debug_mesh, make_production_mesh

    transform, donate = variant_of(arch, shape, variant)
    cfg = jax_config(arch, shape).replace(use_pallas=False)
    if transform is not None:
        cfg = transform(cfg)
    dims = mesh_dims(mesh)
    multi_pod = len(dims) == 3
    debug = dims in ((2, 4), (2, 2, 4))
    jmesh = (make_debug_mesh(multi_pod=multi_pod) if debug
             else make_production_mesh(multi_pod=multi_pod))
    U = jdry._scan_length(cfg)
    counts = []
    with jmesh:
        for u in (1, 2):
            fn, args = jdry.build_lowering(
                arch, shape, jmesh, cfg_override=jdry._cost_variant(cfg, u),
                donate=donate)
            counts.append(hlo_collectives(fn.lower(*args).compile().as_text()))
    c1, c2 = counts
    # per row, not clamped: the rows sum to the JAX package's own
    # extrapolation of each total (a row whose key is made at u = 1 only,
    # outside the scanned layers, extrapolates below zero)
    rows = []
    for key in sorted(set(c1) | set(c2)):
        a, b = c1.get(key, 0), c2.get(key, 0)
        n = float(a + (b - a) * (U - 1))
        if n:
            rows.append(list(key) + [n])
    rows.sort(key=lambda r: -r[-1])
    golden = {k: 0.0 for k in KINDS}
    full = {k: 0.0 for k in KINDS}
    for r in rows:
        full[r[0]] += r[-1]
        if r[4]:
            golden[r[0]] += r[-1]
    golden["total"] = sum(golden.values())
    full["total"] = sum(full.values())
    return {"arch": arch, "shape": shape, "mesh": mesh, "variant": variant,
            "scan_length": U, "golden": golden, "full": full, "rows": rows}


# ---------------------------------------------------------------------------
# printing
# ---------------------------------------------------------------------------

def _gb(n: float) -> str:
    return f"{n:.4e}"


def print_port(res: dict) -> None:
    print(f"## port: {res['arch']} x {res['shape']} x {res['mesh']}"
          + (f" x {res['variant']}" if res["variant"] else ""))
    print(dryrun.sites_table(res["collective_sites"]))
    print("by kind: " + ", ".join(
        f"{k} {_gb(v)}" for k, v in res["collective_bytes"].items()))
    if "peak_sites" in res:
        print(f"\n### live at the temp peak ({_gb(res['temp_bytes'])} B)")
        print("| site (allocating op) | bytes |")
        print("| --- | --- |")
        for site, n in res["peak_sites"][:40]:
            print(f"| `{site}` | {_gb(n)} |")


def dtensor_bytes(sites) -> float:
    """The bytes of the rows of ``collective_sites`` that DTensor's own
    dispatch issued."""
    return sum(r[-1] for r in sites if r[3].startswith(dryrun.DTENSOR_SITE))


def print_jax(res: dict) -> None:
    print(f"## JAX package: {res['arch']} x {res['shape']} x {res['mesh']}"
          + (f" x {res['variant']}" if res["variant"] else "")
          + f" (u = 1, 2 extrapolated to {res['scan_length']})")
    print("| kind | dtype | shape | tuple | in golden's count | promoted "
          "| where | bytes |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    yes = {True: "yes", False: "no"}
    for kind, dt, shape, tup, gold, prom, where, n in res["rows"]:
        print(f"| {kind} | {dt} | {shape} | {yes[tup]} | {yes[gold]} | "
              f"{yes[prom]} | `{where}` | {_gb(n)} |")
    for name in ("golden", "full"):
        print(f"{name}'s count: " + ", ".join(
            f"{k} {_gb(v)}" for k, v in res[name].items()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="16x16",
                    choices=["16x16", "2x16x16", "2x4", "2x2x4"])
    ap.add_argument("--variant", default=None)
    ap.add_argument("--side", default="both",
                    choices=["port", "jax", "both"])
    ap.add_argument("--memory", action="store_true",
                    help="the port's live bytes at the temp peak by site")
    ap.add_argument("--trace", action="store_true",
                    help="put each backward collective that no port frame "
                         "issued down to the forward op that made its "
                         "autograd node (anomaly mode; slower)")
    ap.add_argument("--json", default="", help="write both tables here")
    args = ap.parse_args(argv)
    out = {}
    if args.side in ("port", "both"):
        out["port"] = port_counts(args.arch, args.shape, args.mesh,
                                  args.variant, memory=args.memory,
                                  trace=args.trace)
        print_port(out["port"])
    if args.side in ("jax", "both"):
        out["jax"] = jax_counts(args.arch, args.shape, args.mesh,
                                args.variant)
        print_jax(out["jax"])
    if "port" in out and "jax" in out:
        p = out["port"]["collective_bytes"]["total"]
        print(f"\nport over the JAX package: {p / out['jax']['golden']['total']:.4f}"
              f" (golden's count), {p / out['jax']['full']['total']:.4f} "
              "(full count)")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
