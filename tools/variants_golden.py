#!/usr/bin/env python3
"""The JAX package's own costs of its §Perf variants on the production mesh:
the golden that ``tests/test_torch_variants.py`` holds the port's
``repro_torch.launch.dryrun.cost_extrapolated`` to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/variants_golden.py \\
        [--out tests/golden_variants_jax.json] [--only ARCH:SHAPE:VARIANT]

For each (arch, shape, variant) of ``ROWS`` this runs the unedited JAX
package's ``repro.launch.dryrun.cost_extrapolated`` on the 16x16
production mesh of 512 host placeholder devices (as
``benchmarks/perf_hillclimb.py`` sets them up), with the variant's own
``(cfg_transform, donate)`` from ``benchmarks.perf_hillclimb.VARIANTS``,
imported, not copied. Each row keeps the function's keys (``flops`` a
rank, ``bytes_accessed``, ``collective_bytes``, ``scan_length``,
``u2_temp_bytes``, ``u2_arg_bytes``, ``note``), the seconds it took, the
donation, and the fields the transform sets (``replace``: what it passes
to ``cfg.replace``), so that the port's side can cost the variant without
JAX (``tools/variants_vs_jax.py``, ``chip_smoke.py``); a combination the
JAX package cannot lower is kept under ``failures`` with its error. About
3 minutes on an 8-core CPU; CPU counts, not speeds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# before JAX is imported: 512 host devices, as perf_hillclimb sets them
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]

MESH = "16x16"
ROWS = (
    ("deepseek-v2-lite-16b", "train_4k", "capacity_moe"),
    ("deepseek-v2-lite-16b", "train_4k", "capacity_moe_ep"),
    ("deepseek-v2-lite-16b", "train_4k", "top1_router"),
    ("deepseek-v2-lite-16b", "train_4k", "no_remat"),
    ("llama4-scout-17b-a16e", "train_4k", "capacity_moe"),
    ("llama4-scout-17b-a16e", "train_4k", "capacity_moe_ep"),
    ("deepseek-v2-lite-16b", "prefill_32k", "capacity_moe_chunked_attn"),
    ("tinyllama-1.1b", "prefill_32k", "chunked_attention"),
    ("chameleon-34b", "prefill_32k", "chunked_attention"),
    ("phi3-medium-14b", "decode_32k", "scatter_kv"),
    ("phi3-medium-14b", "decode_32k", "scatter_kv_donated"),
    ("tinyllama-1.1b", "train_4k", "donate_train_state"),
)


class _Fields:
    """A config stand-in that records what ``replace`` is given."""

    def __init__(self):
        self.fields = {}

    def replace(self, **kw):
        self.fields.update(kw)
        return self


def replaced(transform) -> dict:
    """The fields a variant's ``cfg_transform`` sets (none for None)."""
    if transform is None:
        return {}
    rec = _Fields()
    transform(rec)
    return rec.fields


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        HERE, "tests", "golden_variants_jax.json"))
    ap.add_argument("--only", default="",
                    help="ARCH:SHAPE:VARIANT[,...]: these rows alone")
    args = ap.parse_args(argv)

    from benchmarks.perf_hillclimb import VARIANTS
    from repro.launch.dryrun import cost_extrapolated
    from repro.launch.mesh import make_production_mesh

    rows = [r for r in ROWS if not args.only
            or ":".join(r) in args.only.split(",")]
    mesh = make_production_mesh()
    assert "x".join(str(v) for v in mesh.shape.values()) == MESH
    results, failures = [], []
    with mesh:
        for arch, shape, variant in rows:
            _, transform, donate = VARIANTS[variant]
            t0 = time.time()
            try:
                cost = cost_extrapolated(arch, shape, mesh,
                                         cfg_transform=transform,
                                         donate=donate)
            except Exception as e:  # noqa: BLE001
                failures.append({"arch": arch, "shape": shape,
                                 "mesh": MESH, "variant": variant,
                                 "donate": donate,
                                 "replace": replaced(transform),
                                 "error": str(e)[:500]})
                print(f"[variants] FAIL {arch} x {shape} x {variant}: "
                      f"{str(e)[:200]}", flush=True)
                continue
            results.append({"arch": arch, "shape": shape, "mesh": MESH,
                            "variant": variant, "donate": donate,
                            "replace": replaced(transform),
                            "extrapolated": cost,
                            "compile_s": round(time.time() - t0, 2)})
            print(f"[variants] {arch} x {shape} x {variant}: flops="
                  f"{cost['flops']:.4e} coll="
                  f"{cost['collective_bytes']['total']:.4e} u2_temp="
                  f"{cost['u2_temp_bytes']:.4e} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    with open(args.out, "w") as f:
        json.dump({"mesh": MESH, "results": results, "failures": failures},
                  f, indent=1)
        f.write("\n")
    print(f"[variants] {len(results)} ok, {len(failures)} failed")


if __name__ == "__main__":
    main()
