"""Each placed step of the port splits its work over the production meshes
as the JAX package's partitioned program does.

``tests/golden_dryrun_jax.json`` is the JAX package's own dry-run of every
(arch x shape x mesh), made on the CPU by

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun --all \\
        --mesh both --cost-extrapolate --out tests/golden_dryrun_jax.json

Its ``extrapolated`` block counts every layer (XLA's own count covers a
scan body once). For one (arch, shape, mesh) or more of each model family,
the port's dry-run (``repro_torch.launch.dryrun.run_one``, meta tensors
over a ``fake`` group as wide as the mesh) must count at most
``dryrun.JAX_FLOPS_BOUND`` (1.25) x the JAX package's FLOPs a rank, at
most 2 x its collective bytes and at most ``dryrun.JAX_TEMP_BOUND`` (1.5)
x its ``temp_size_bytes`` (and as much x the ``u2_temp_bytes`` of its
block, the u = 2 variant's), on the JAX package's argument bytes (the rules
place the same shards) but for the two departures ``PERF.md`` names. The
FLOPs a rank are matmul FLOPs in the port and every op's in XLA, so the
port may count fewer. Some rows hold more (``TIGHTER``): Mamba-2's
collective bytes (its in-projection exchanged, not gathered) and, where
"model" divides the query heads but not the kv heads, the all-gather
bytes, at most the JAX package's all-gather and collective-permute bytes
(each kv head gathered only among the ranks that read it), and
deepseek-v2-lite-16b's train step, whose total is held both to the
golden's count and, tighter, to the JAX package's full count
(``FULL_COUNT``: ``tools/dryrun_sites.py``, which counts the tuple-shaped
all-reduces that XLA combined and the golden's parser skips). No row has a
collective that DTensor's own sharding propagation issued
(``collective_sites``).

recurrentgemma-9b's train and prefill are left out: its plain RG-LRU walks
time token by token, 9-14 minutes a step on meta tensors.
"""
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.models.common import init_shapes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden_dryrun_jax.json")
COLLECTIVE_BOUND = 2.0
MODEL_WIDTH = 16  # the production meshes' "model" axis

ROWS = [
    ("tinyllama-1.1b", "train_4k", "2x16x16"),
    ("tinyllama-1.1b", "prefill_32k", "16x16"),
    ("mamba2-1.3b", "decode_32k", "16x16"),
    ("deepseek-v2-lite-16b", "prefill_32k", "16x16"),
    ("whisper-medium", "prefill_32k", "16x16"),
    ("recurrentgemma-9b", "decode_32k", "2x16x16"),
    ("chameleon-34b", "decode_32k", "16x16"),
    # logits the vocab split misses (51,865 over 16): the loss on each
    # rank's rows, no buffer of the global batch's logits
    ("whisper-medium", "train_4k", "2x16x16"),
    ("mamba2-1.3b", "train_4k", "2x16x16"),
    ("mamba2-1.3b", "prefill_32k", "16x16"),
    ("nemotron-4-15b", "prefill_32k", "16x16"),
    # the dense MoE dispatch's train step: one fp32 reduce of an MoE
    # layer's output, the shared experts' partial sums in it
    ("deepseek-v2-lite-16b", "train_4k", "16x16"),
]
# (arch, shape, mesh) -> {what: bound over the JAX package's}
KV_GATHER = {"all-gather": 1.0}
TIGHTER = {
    ("mamba2-1.3b", "train_4k", "2x16x16"): {"total": 1.1},
    ("mamba2-1.3b", "prefill_32k", "16x16"): {"total": 1.1},
    ("tinyllama-1.1b", "train_4k", "2x16x16"): KV_GATHER,
    ("tinyllama-1.1b", "prefill_32k", "16x16"): KV_GATHER,
    ("nemotron-4-15b", "prefill_32k", "16x16"): KV_GATHER,
    ("deepseek-v2-lite-16b", "train_4k", "16x16"): {"total": 1.21},
}
# (arch, shape, mesh) -> the bound over the JAX package's collective bytes
# counted in full by ``tools/dryrun_sites.py``, the tuple-shaped
# all-reduces XLA combined (which the golden's parser skips) included
FULL_COUNT = {("deepseek-v2-lite-16b", "train_4k", "16x16"): 0.4}


def golden():
    with open(GOLDEN) as f:
        data = json.load(f)
    return {(r["arch"], r["shape"], r["mesh"]): r for r in data["results"]}


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def test_golden_covers_every_combination():
    """The reference holds all 80 combinations, each with its
    depth-extrapolated block, and none failed."""
    with open(GOLDEN) as f:
        data = json.load(f)
    assert data["failures"] == []
    rows = golden()
    assert len(rows) == 80 and set(ROWS) <= set(rows)
    for r in rows.values():
        e = r["extrapolated"]
        assert e["flops"] > 0 and "total" in e["collective_bytes"]
        assert r["devices"] == (256 if r["mesh"] == "16x16" else 512)


def _leaves(tree, name):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == name:
                yield v
            else:
                yield from _leaves(v, name)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, name)


def port_only_bytes(arch, shape, devices):
    """The argument bytes a rank that the port holds beyond the JAX
    package's: in a decode step, mamba2's ``pos`` (B,) int32, which its
    step never reads and XLA drops, and recurrentgemma's RG-LRU gate
    matrices, fp32 in the port (``GATES_FP32``) and bf16 in the JAX
    package, 2 B more an element, split over "model". Any other model's,
    and mamba2's train and prefill steps', none."""
    sh = get_shape(shape)
    if arch == "mamba2-1.3b" and sh.kind == "decode":
        return sh.global_batch // (devices // MODEL_WIDTH) * 4
    if arch != "recurrentgemma-9b":
        return 0
    assert sh.kind == "decode", "counted for a decode step only"
    params = init_shapes(build_model(get_config(arch)))
    gates = [w for name in ("w_input_gate", "w_rec_gate")
             for w in _leaves(params, name)]
    return sum(w.numel() for w in gates) * 2 // MODEL_WIDTH


@pytest.mark.parametrize("arch,shape,mesh", ROWS)
def test_placed_step_splits_as_the_jax_package(arch, shape, mesh):
    ref = golden()[(arch, shape, mesh)]
    r = dryrun.run_one(arch, shape, multi_pod=mesh == "2x16x16",
                       verbose=False, extrapolate=True)
    assert r["mesh"] == mesh and r["devices"] == ref["devices"]
    ext = ref["extrapolated"]
    assert r["flops"] <= dryrun.JAX_FLOPS_BOUND * ext["flops"], (
        r["flops"], ext["flops"])
    coll, ref_coll = (r["collective_bytes"]["total"],
                      ext["collective_bytes"]["total"])
    assert coll <= COLLECTIVE_BOUND * ref_coll, (coll, ref_coll)
    assert r["memory"]["argument_size_bytes"] == (
        ref["memory"]["argument_size_bytes"]
        + port_only_bytes(arch, shape, r["devices"]))
    temp, ref_temp = (r["memory"]["temp_size_bytes"],
                      ref["memory"]["temp_size_bytes"])
    assert temp <= dryrun.JAX_TEMP_BOUND * ref_temp, (temp, ref_temp)
    # the u = 2 variant's temp bytes, as the JAX package's block holds them
    u2, ref_u2 = (r["extrapolated"]["u2_temp_bytes"], ext["u2_temp_bytes"])
    assert u2 <= dryrun.JAX_TEMP_BOUND * ref_u2, (u2, ref_u2)
    for what, bound in TIGHTER.get((arch, shape, mesh), {}).items():
        # the JAX package's all-gathers and collective-permutes both
        # bring a rank what it lacks
        want = ref_coll if what == "total" else (
            ext["collective_bytes"]["all-gather"]
            + ext["collective_bytes"]["collective-permute"])
        got = r["collective_bytes"][what]
        assert got <= bound * want, (what, got, want)
    # a rank's share of the whole step: at least an even split
    assert r["flops"] * r["devices"] >= r["flops_global"]
    # every collective is one a placed op states: none that DTensor's own
    # sharding propagation chose
    own = [row for row in r["collective_sites"]
           if row[3].startswith(dryrun.DTENSOR_SITE)]
    assert not own, own
    if (arch, shape, mesh) in FULL_COUNT:
        full = jax_sites(arch, shape, mesh)
        # the tool's count of what the golden's parser counts is the
        # golden's own
        for kind, n in ext["collective_bytes"].items():
            assert full["golden"][kind] == pytest.approx(n, rel=1e-12), kind
        assert coll <= FULL_COUNT[(arch, shape, mesh)] * full["full"][
            "total"], (coll, full["full"]["total"])


def jax_sites(arch, shape, mesh):
    """``tools/dryrun_sites.py``'s JAX side (``jax_counts``) of (arch,
    shape, mesh), run in a subprocess: JAX fixes its host device count when
    it starts."""
    code = "\n".join((
        "import json, sys",
        "sys.path.insert(0, 'tools')",
        "import dryrun_sites",
        f"print(json.dumps(dryrun_sites.jax_counts({arch!r}, {shape!r}, "
        f"{mesh!r})))"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])
