"""The JAX package's §Perf variants costed by the port: each placed step
with a variant's config transform and donation splits its work over the
16x16 production mesh as the JAX package's partitioned program does.

``tests/golden_variants_jax.json`` is the unedited JAX package's own
``repro.launch.dryrun.cost_extrapolated`` of each (arch, shape, variant),
with ``benchmarks.perf_hillclimb.VARIANTS``' own ``(cfg_transform,
donate)``, made on the CPU by

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/variants_golden.py

For each row the port's ``repro_torch.launch.dryrun.cost_extrapolated``
(meta tensors over a ``fake`` group of 256 ranks), with the same
transform and donation, must count at most ``dryrun.JAX_FLOPS_BOUND``
(1.25) x the JAX package's FLOPs a rank, at most 2 x its collective bytes
and at most ``dryrun.JAX_TEMP_BOUND`` (1.5) x its ``u2_temp_bytes``. On
the rows with the expert-parallel constraint the port's FLOPs a rank
times the ranks must also be at most 1.25 x its own ``flops_global``
(the whole step's): the experts' work is split, not replicated. Some rows
hold tighter collective bounds (``TIGHTER``); no row has a collective that
DTensor's own sharding propagation issued (``collective_sites``), and
capacity_moe_ep's collective bytes are pinned, kind by kind, to the byte
(``tests/pinned_port_collectives.json``, which ``chip_smoke.py`` holds the
card's torch release to as well). Counts on meta tensors, not speeds.
"""
import json
import os

import pytest
import torch.distributed as dist

from benchmarks.perf_hillclimb import VARIANTS
from repro_torch.configs import config_for_shape
from repro_torch.launch import dryrun

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_variants_jax.json")
PINNED = os.path.join(os.path.dirname(__file__), "pinned_port_collectives.json")
COLLECTIVE_BOUND = 2.0
MESH = (16, 16)
# (arch, shape, variant) -> a tighter bound on the collective bytes over
# the JAX package's: the dense dispatch's train step, its shared experts'
# partial sums in the experts' one fp32 reduce
TIGHTER = {
    ("deepseek-v2-lite-16b", "train_4k", "top1_router"): 1.21,
    ("deepseek-v2-lite-16b", "train_4k", "no_remat"): 1.21,
}
ROWS = [
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
]


def pinned():
    """(arch, shape, variant) -> the port's collective bytes by kind on
    MESH, pinned to the byte (``PINNED``)."""
    with open(PINNED) as f:
        rows = json.load(f)["rows"]
    return {(r["arch"], r["shape"], r["variant"]): r["collective_bytes"]
            for r in rows if r["mesh"] == "x".join(map(str, MESH))}


def golden():
    with open(GOLDEN) as f:
        data = json.load(f)
    return {(r["arch"], r["shape"], r["variant"]): r
            for r in data["results"]}


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def test_golden_holds_every_row():
    """The JAX package lowered every row on the 16x16 mesh, with the
    variant's own donation and config fields, and its block has the
    reference's keys."""
    with open(GOLDEN) as f:
        data = json.load(f)
    assert data["mesh"] == "16x16" and data["failures"] == []
    rows = golden()
    assert sorted(rows) == sorted(ROWS)
    for (arch, shape, variant), r in rows.items():
        _, transform, donate = VARIANTS[variant]
        assert r["donate"] == donate
        # the fields the row records are what the transform sets
        cfg = config_for_shape(arch, shape)
        assert cfg.replace(**r["replace"]) == (
            transform(cfg) if transform else cfg)
        e = r["extrapolated"]
        assert {"flops", "bytes_accessed", "collective_bytes", "scan_length",
                "u2_temp_bytes", "u2_arg_bytes", "note"} <= set(e)
        assert e["flops"] > 0 and e["u2_temp_bytes"] > 0


def test_pinned_rows_are_counted_rows():
    """Every row pinned to the byte is one this file costs, and names
    every kind of collective."""
    rows = pinned()
    assert rows and set(rows) <= set(ROWS)
    for counts in rows.values():
        assert set(counts) == {"all-reduce", "all-gather", "reduce-scatter",
                               "all-to-all", "collective-permute", "total"}
        assert counts["total"] == sum(v for k, v in counts.items()
                                      if k != "total")


@pytest.mark.parametrize("arch,shape,variant", ROWS)
def test_variant_splits_as_the_jax_package(arch, shape, variant):
    ref = golden()[(arch, shape, variant)]["extrapolated"]
    _, transform, donate = VARIANTS[variant]
    got = dryrun.cost_extrapolated(arch, shape, MESH, cfg_transform=transform,
                                   donate=donate)
    cfg = config_for_shape(arch, shape)
    if transform is not None:
        cfg = transform(cfg)
    assert got["scan_length"] == ref["scan_length"]
    assert got["flops"] <= dryrun.JAX_FLOPS_BOUND * ref["flops"], (
        got["flops"], ref["flops"])
    coll, ref_coll = (got["collective_bytes"]["total"],
                      ref["collective_bytes"]["total"])
    assert coll <= COLLECTIVE_BOUND * ref_coll, (coll, ref_coll)
    bound = TIGHTER.get((arch, shape, variant))
    if bound is not None:
        assert coll <= bound * ref_coll, (coll, ref_coll)
    # every collective is one a placed op states (none that DTensor's own
    # sharding propagation chose), so the count is the same in every torch
    # release: where it is pinned, to the byte
    own = [row for row in got["collective_sites"]
           if row[3].startswith(dryrun.DTENSOR_SITE)]
    assert not own, own
    want = pinned().get((arch, shape, variant))
    if want is not None:
        assert got["collective_bytes"] == want
    assert got["u2_temp_bytes"] <= dryrun.JAX_TEMP_BOUND * ref[
        "u2_temp_bytes"], (got["u2_temp_bytes"], ref["u2_temp_bytes"])
    ranks = MESH[0] * MESH[1]
    # a rank's share of the whole step: at least an even split
    assert got["flops"] * ranks >= got["flops_global"]
    if cfg.moe_ep_constraint:
        # and at most 1.25 x one: the experts' work is not replicated
        assert got["flops"] * ranks <= dryrun.JAX_FLOPS_BOUND * got[
            "flops_global"], (got["flops"] * ranks, got["flops_global"])
