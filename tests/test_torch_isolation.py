"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package ``repro``.

A subprocess blocks ``jax`` (``sys.modules["jax"] = None``) and rejects any
import of ``repro`` / ``repro.*`` with an import hook, then imports every
module of ``repro_torch`` and ``chip_smoke`` (without running it), after
which no process group may be set up (``torch.distributed.is_initialized``
False): the dry-run sets one up only when it runs. A source
scan backs it up for imports that run only inside functions.
"""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")

_CHILD = r'''
import importlib, importlib.abc, os, pkgutil, sys
sys.modules["jax"] = None

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
root = sys.argv[1]
sys.path[:0] = [os.path.join(root, "src"), root]
import repro_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
# the MoE, MLA and encoder-decoder path, imported above without JAX or
# repro
from repro_torch.models import attention, blocks, common, encdec
for fn in (blocks.init_moe, blocks.moe_forward_dense,
           blocks.moe_forward_capacity, attention.init_mla,
           attention.mla_forward, attention.mla_decode,
           attention.flash_attention_chunked, attention.cross_attention,
           attention.encoder_kv, common.layer_norm,
           common.sinusoidal_positions, encdec.EncDecLM,
           common.softmax_cross_entropy, common.remat):
    assert callable(fn)
# the training path, imported above without JAX or repro
from repro_torch import training
from repro_torch.data import synthetic_token_batches
from repro_torch.launch import train
for fn in (training.adamw_update, training.make_train_step, training.train,
           training.save_checkpoint, training.load_checkpoint,
           synthetic_token_batches, train.main):
    assert callable(fn)
# the distribution layer and the dry-run, imported above: no process group
# is set up at import
from repro_torch import distributed
from repro_torch.launch import dryrun, mesh
import torch.distributed as torch_dist
for fn in (distributed.param_pspecs, distributed.cache_pspecs,
           distributed.to_placements, distributed.with_sharding,
           mesh.make_production_mesh, mesh.make_debug_mesh,
           dryrun.build_lowering, dryrun.run_one, dryrun.main):
    assert callable(fn)
# the §Perf variants: the placed capacity dispatch and the costing API
from repro_torch.distributed import parallel
for fn in (parallel.moe_capacity, blocks.capacity_experts,
           dryrun.cost_extrapolated, dryrun._cost_variant):
    assert callable(fn)
assert not torch_dist.is_initialized(), "a module set up a process group"
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m in ("repro", "jax") or m.startswith(("repro.", "jax."))))
assert not bad, bad
print(" ".join(names))
'''

# the modules of the SSM and hybrid path, the CUDA graphs and the baseline
# policies, those that hold the MoE blocks, MLA, the chunked reference and
# the MoE/MLA decoder, the encoder-decoder, the Azure trace, phased tuner,
# fleet layer and serve CLI, and the training path (optimizer, train loop,
# checkpoints, the synthetic data and the train CLI), and the distribution
# layer and the dry-run, which the walk must reach
PATH_MODULES = {"repro_torch.kernels.ssd", "repro_torch.kernels.rglru",
                "repro_torch.models.ssm", "repro_torch.models.hybrid",
                "repro_torch.serving.graphs", "repro_torch.policies.fixed",
                "repro_torch.policies.rules", "repro_torch.models.blocks",
                "repro_torch.models.attention",
                "repro_torch.models.transformer",
                "repro_torch.models.encdec",
                "repro_torch.models.convert",
                "repro_torch.workloads.azure_trace",
                "repro_torch.configs.shapes", "repro_torch.energy.phases",
                "repro_torch.core.tuner2d", "repro_torch.policies.phased",
                "repro_torch.core.stacked", "repro_torch.policies.fleet",
                "repro_torch.policies.hierarchy",
                "repro_torch.serving.network", "repro_torch.serving.faults",
                "repro_torch.serving.fleet_step",
                "repro_torch.serving.cluster", "repro_torch.launch",
                "repro_torch.launch.serve", "repro_torch.training",
                "repro_torch.training.optimizer",
                "repro_torch.training.train_loop",
                "repro_torch.training.checkpoint", "repro_torch.data",
                "repro_torch.data.pipeline", "repro_torch.launch.train",
                "repro_torch.distributed",
                "repro_torch.distributed.sharding",
                "repro_torch.distributed.parallel",
                "repro_torch.launch.mesh", "repro_torch.launch.dryrun"}


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _CHILD, ROOT],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 81 and PATH_MODULES <= names


def test_cuda_sources_include_only_cuda_headers():
    """Each ``csrc`` source behind a kernel wrapper includes the CUDA
    toolkit's headers and the port's own ``common.cuh``, nothing else."""
    csrc = os.path.join(PKG, "csrc")
    allowed = re.compile(r'#include\s+(<cuda[\w_]*\.h>|<stdint\.h>'
                         r'|"common\.cuh")')
    names = sorted(f for f in os.listdir(csrc) if f.endswith((".cu", ".cuh")))
    assert {"rmsnorm.cu", "ssd_scan.cu", "rglru_scan.cu",
            "decode_attention.cu", "flash_attention.cu"} <= set(names)
    bad = []
    for f in names:
        with open(os.path.join(csrc, f)) as fh:
            for line in fh:
                if line.lstrip().startswith("#include") and \
                        not allowed.match(line.strip()):
                    bad.append(f"{f}: {line.strip()}")
    assert not bad, bad


def test_no_jax_or_repro_import_in_sources():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)"
                     r"|from\s+(jax|repro)\b(?!_torch))", re.M)
    hits = []
    for path in _sources():
        with open(path) as f:
            for m in pat.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, ROOT)}: {m.group(0)}")
    assert not hits, hits
