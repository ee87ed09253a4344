"""``tools/dryrun_sites.py``: one (arch, shape, mesh)'s collective bytes by
the site that issues them, the port's beside the JAX package's.

The port's table comes from the dry-run's own counter
(``repro_torch.launch.dryrun.StepCounter.collective_sites``), so its rows
must add up to the dry-run's ``collective_bytes`` kind by kind. The JAX
package's comes from its partitioned HLO: its rows that
``repro.launch.dryrun.collective_bytes`` counts must add up to that
function's count, and the tuple-shaped collectives (all-reduces XLA
combined) that the function skips are counted apart. The JAX package fixes
its host device count when JAX starts, so its side runs in a subprocess,
as ``tests/test_dryrun.py`` runs the JAX package's dry-run.
"""
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.launch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import dryrun_sites  # noqa: E402

# a partitioned module's text as XLA prints it: a stack-frame table, an
# all-reduce whose sum the CPU backend promoted to f32, a tuple-shaped
# all-reduce (two that XLA combined) and an all-gather
HLO = """HloModule jit_step, num_partitions=8

FileNames
1 "{src}/repro/models/transformer.py"
2 "{src}/repro/models/blocks.py"

FunctionNames
1 "DecoderOnlyLM.forward"
2 "ffn_forward"

FileLocations
1 {{file_name_id=1 function_name_id=1 line=90 end_line=90 column=1 end_column=1}}
2 {{file_name_id=2 function_name_id=2 line=38 end_line=38 column=1 end_column=1}}

StackFrames
1 {{file_location_id=1 parent_frame_id=1}}
2 {{file_location_id=2 parent_frame_id=2}}

ENTRY %main (p: f32[16,8]) -> f32[16,8] {{
  %ar.1 = f32[16,8]{{1,0}} all-reduce(%x), channel_id=1, replica_groups=[2,4]<=[8], to_apply=%add.1.clone_promoted, metadata={{op_name="jit(step)/jvp()/dot_general" stack_frame_id=2}}
  %ar.2 = (f32[16,8]{{1,0}}, f32[4]{{0}}) all-reduce(%a, %b), channel_id=2, replica_groups=[2,4]<=[8], to_apply=%add.2, metadata={{op_name="jit(step)/transpose(jvp())/dot_general"}}
  %ag.1 = bf16[4,1024]{{1,0}} all-gather(%y), channel_id=3, dimensions={{0}}
  ROOT %dot = f32[16,8]{{1,0}} dot(%p, %p)
}}
""".format(src=os.path.join(REPO, "src"))


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def test_port_table_sums_to_the_dry_run():
    """The tool's port table of tinyllama-1.1b's train step on the 2x4
    debug mesh adds up, kind by kind, to ``run_one``'s collective bytes,
    is ``run_one``'s own table, and has no row that DTensor's own dispatch
    issued."""
    got = dryrun_sites.port_counts("tinyllama-1.1b", "train_4k", "2x4")
    ref = dryrun.run_one("tinyllama-1.1b", "train_4k", debug_mesh=True,
                         verbose=False)
    by_kind = {kind: 0 for kind in dryrun_sites.KINDS}
    for kind, dtype, phase, site, n in got["collective_sites"]:
        assert phase in ("forward", "backward", "recompute")
        by_kind[kind] += n
    by_kind["total"] = sum(by_kind.values())
    assert by_kind == ref["collective_bytes"] == got["collective_bytes"]
    assert by_kind["total"] > 0
    assert got["collective_sites"] == ref["collective_sites"]
    assert dryrun_sites.dtensor_bytes(got["collective_sites"]) == 0
    # the row-parallel products' reduce: the rows name the port's op
    assert any("linear" in site for _, _, _, site, _ in
               got["collective_sites"])


def test_hlo_rows_count_what_the_golden_counts_and_the_tuples():
    """Of a module's collectives, the rows the JAX package's
    ``collective_bytes`` counts add up to its count, kind by kind; the
    tuple-shaped all-reduce it skips is counted apart, and each row names
    its op and the source line it was made for."""
    os.environ.setdefault("XLA_FLAGS", "")
    from repro.launch.dryrun import collective_bytes

    rows = dryrun_sites.hlo_collectives(HLO)
    golden = collective_bytes(HLO)
    for kind in dryrun_sites.KINDS:
        assert sum(n for key, n in rows.items()
                   if key[0] == kind and key[4]) == golden[kind], kind
    ar = ("all-reduce", "f32", "[16,8]")
    assert rows[ar + (False, True, True,
                      "jvp()/dot_general @ repro/models/blocks.py:38 "
                      "ffn_forward < repro/models/transformer.py:90 "
                      "DecoderOnlyLM.forward")] == 16 * 8 * 4 * 2
    tuples = {key: n for key, n in rows.items() if key[3]}
    assert sum(tuples.values()) == (16 * 8 + 4) * 4 * 2
    assert all(not key[4] and not key[5] for key in tuples)
    assert golden["all-gather"] == 4 * 1024 * 2


def test_jax_side_extrapolates_the_golden_count(tmp_path):
    """The tool's JAX side of tinyllama-1.1b's train step on the 2x4 debug
    mesh (a subprocess): its golden count is the JAX package's own
    ``cost_extrapolated`` collective bytes, and its full count, with the
    all-reduces XLA combined into tuples, is larger."""
    out = str(tmp_path / "sites.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = "\n".join((
        "import json, sys",
        "sys.path.insert(0, 'tools')",
        "import dryrun_sites as t",
        "from repro.launch import dryrun as d",
        "from repro.launch.mesh import make_debug_mesh",
        "got = t.jax_counts('tinyllama-1.1b', 'train_4k', '2x4')",
        "mesh = make_debug_mesh()",
        "with mesh:",
        "    ref = d.cost_extrapolated('tinyllama-1.1b', 'train_4k', mesh)",
        f"json.dump([got, ref['collective_bytes']], open({out!r}, 'w'))"))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out) as f:
        got, ref = json.load(f)
    for kind in dryrun_sites.KINDS + ("total",):
        assert got["golden"][kind] == pytest.approx(ref[kind], rel=1e-12), kind
    assert got["full"]["all-reduce"] > 2 * got["golden"]["all-reduce"]
    assert got["full"]["total"] == pytest.approx(
        sum(row[-1] for row in got["rows"]), rel=1e-12)
