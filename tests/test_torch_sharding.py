"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's (``repro.distributed.sharding``), on the CPU.

The tests of ``tests/test_sharding.py`` run on the port, each beside the
reference's spec for the same shapes. Then every family's shape-only param
tree and decode cache, at full size, is specced and placed leaf for leaf
against the reference's specs of ``jax.eval_shape`` of the same config: a
leaf of a per-layer list must carry the stacked leaf's spec without its
leading (layer) entry, and its local shape must be JAX's shard shape
without the layer axis. Last, a dim split over ("pod", "data") must give
each rank the slice that JAX gives the device at the same mesh coordinate.

The port's meshes are ``DeviceMesh``es over a ``fake`` process group that
each test sets up and destroys (``dryrun.fake_process_group``); the
reference's are the fake meshes of ``tests/test_sharding.py``. Specs are
compared exactly.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro.configs import config_for_shape as jax_config_for_shape
from repro.distributed.sharding import _path_to_str as jax_path_to_str
from repro.distributed.sharding import batch_pspec as jax_batch_pspec
from repro.distributed.sharding import cache_pspecs as jax_cache_pspecs
from repro.distributed.sharding import logits_pspec as jax_logits_pspec
from repro.distributed.sharding import param_pspecs as jax_param_pspecs
from repro.distributed.sharding import sanitize_spec as jax_sanitize_spec
from repro.models import build_model as jax_build_model
from repro_torch.configs import ASSIGNED_ARCHS, config_for_shape
from repro_torch.distributed import (PSpec, batch_pspec, cache_pspecs,
                                     logits_pspec, param_pspecs,
                                     sanitize_spec, to_placements,
                                     with_sharding)
from repro_torch.distributed.sharding import placement_mesh
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model
from repro_torch.models.blocks import GATES_FP32
from repro_torch.models.common import init_shapes

def jax_fake_mesh(shape=(2, 4), names=("data", "model")):
    devs = np.array(jax.devices() * int(np.prod(shape)))[:int(np.prod(shape))]
    return Mesh(devs.reshape(shape), names)


JMESH = jax_fake_mesh()


@pytest.fixture
def mesh():
    """The port's 2x4 debug mesh over a fake group of 8 ranks."""
    with fake_process_group(8):
        yield make_debug_mesh(device_type="cpu")


def meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def sds(shape, dtype=jnp.bfloat16):
    return jax.ShapeDtypeStruct(shape, dtype)


def same(port_spec, jax_spec):
    return tuple(port_spec) == tuple(jax_spec)


# ---------------------------------------------------------------------------
# tests/test_sharding.py, on the port, each beside the reference
# ---------------------------------------------------------------------------

class TestSanitize:
    def test_drops_nondivisible(self, mesh):
        spec = sanitize_spec(PSpec(None, "model"), (10, 51865), mesh)
        assert spec == PSpec(None, None)
        assert same(spec, jax_sanitize_spec(P(None, "model"), (10, 51865),
                                            JMESH))

    def test_keeps_divisible(self, mesh):
        spec = sanitize_spec(PSpec(None, "model"), (10, 512), mesh)
        assert spec == PSpec(None, "model")
        assert same(spec, jax_sanitize_spec(P(None, "model"), (10, 512),
                                            JMESH))

    def test_tuple_axes(self, mesh):
        for shape in ((8, 3), (6, 3)):
            spec = sanitize_spec(PSpec(("data", "model"), None), shape, mesh)
            assert same(spec, jax_sanitize_spec(P(("data", "model"), None),
                                                shape, JMESH))
        assert sanitize_spec(PSpec(("data", "model"), None), (8, 3),
                             mesh) == PSpec(("data", "model"), None)
        assert sanitize_spec(PSpec(("data", "model"), None), (6, 3),
                             mesh) == PSpec(None, None)


class TestParamSpecs:
    def test_dense_rules(self, mesh):
        shapes = {"embed": (32000, 2048), "lm_head": (2048, 32000),
                  "layers": {"attn": {"wq": (22, 2048, 2048),
                                      "wo": (22, 2048, 2048)}}}
        specs = param_pspecs(_tree(shapes, meta), mesh)
        ref = jax_param_pspecs(_tree(shapes, sds), JMESH)
        assert specs["embed"] == PSpec("model", None)
        assert specs["lm_head"] == PSpec(None, "model")
        # stacked params get a leading unsharded layer axis
        assert specs["layers"]["attn"]["wq"] == PSpec(None, None, "model")
        assert specs["layers"]["attn"]["wo"] == PSpec(None, "model", None)
        for k in ("embed", "lm_head"):
            assert same(specs[k], ref[k])
        for k in ("wq", "wo"):
            assert same(specs["layers"]["attn"][k],
                        ref["layers"]["attn"][k])

    def test_moe_expert_parallel(self, mesh):
        shapes = {"layers": {"moe": {"w_in": (26, 64, 2048, 1408),
                                     "w_out": (26, 64, 1408, 2048),
                                     "router": (26, 2048, 64)}}}
        specs = param_pspecs(_tree(shapes, meta), mesh)["layers"]["moe"]
        ref = jax_param_pspecs(_tree(shapes, sds), JMESH)["layers"]["moe"]
        assert specs["w_in"] == PSpec(None, "model", None, None)
        assert specs["w_out"] == PSpec(None, "model", None, None)
        assert specs["router"] == PSpec(None, None, None)
        for k in specs:
            assert same(specs[k], ref[k])

    def test_nondivisible_vocab_replicates(self, mesh):
        specs = param_pspecs({"embed": meta((51865, 1024), torch.float32)},
                             mesh)
        ref = jax_param_pspecs({"embed": sds((51865, 1024), jnp.float32)},
                               JMESH)
        assert specs["embed"] == PSpec(None, None)
        assert same(specs["embed"], ref["embed"])


class TestCacheSpecs:
    @staticmethod
    def both(shape, batch, mesh):
        port = cache_pspecs({"scanned": {"k": meta(shape)}}, mesh, batch)
        ref = jax_cache_pspecs({"scanned": {"k": sds(shape)}}, JMESH, batch)
        assert same(port["scanned"]["k"], ref["scanned"]["k"])
        return port["scanned"]["k"]

    def test_kv_head_parallel_when_divisible(self, mesh):
        spec = self.both((22, 8, 128, 4, 64), 8, mesh)
        assert spec == PSpec(None, ("data",), None, "model", None)

    def test_context_parallel_fallback(self, mesh):
        # Hkv=1 cannot shard over model=4 -> shard cache length instead
        spec = self.both((22, 8, 128, 1, 64), 8, mesh)
        assert spec == PSpec(None, ("data",), "model", None, None)

    def test_batch_one_replicates_batch_axis(self, mesh):
        spec = self.both((22, 1, 128, 4, 64), 1, mesh)
        assert spec[1] is None


class TestBatchAndLogits:
    def test_batch_sharded_when_divisible(self, mesh):
        assert batch_pspec(mesh, 8)[0] in ("data", ("data",))
        assert batch_pspec(mesh, 3)[0] is None
        for b in (8, 3):
            assert same(batch_pspec(mesh, b), jax_batch_pspec(JMESH, b))

    def test_logits_vocab_guard(self, mesh):
        assert logits_pspec(mesh, 8, 32000)[-1] == "model"
        assert logits_pspec(mesh, 8, 51865)[-1] is None
        for v in (32000, 51865):
            assert same(logits_pspec(mesh, 8, v),
                        jax_logits_pspec(JMESH, 8, v))


def _tree(shapes, leaf):
    if isinstance(shapes, dict):
        return {k: _tree(v, leaf) for k, v in shapes.items()}
    return leaf(shapes)


# ---------------------------------------------------------------------------
# every family's param and cache trees, leaf for leaf
# ---------------------------------------------------------------------------

# keys whose leaves the JAX package stacks on a leading layer axis and the
# port keeps as per-layer lists
_STACKED = ("layers", "units", "enc_layers", "dec_layers")


def port_leaves(tree, path=()):
    """(the JAX path of the leaf, whether the port holds one layer of a
    stacked leaf there, the leaf) of each leaf of a port tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from port_leaves(v, path + (str(k),))
    elif isinstance(tree, list):
        stacked = bool(path) and path[-1] in _STACKED
        for i, v in enumerate(tree):
            sub = path if stacked else path + (str(i),)
            for p, was, leaf in port_leaves(v, sub):
                yield p, was or stacked, leaf
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from port_leaves(v, path + (f,))
    else:
        yield "/".join(path), False, tree


def jax_leaves(tree, specs):
    """{path: (shape, dtype name, spec)} of a ShapeDtypeStruct tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {jax_path_to_str(path): (tuple(leaf.shape), leaf.dtype.name, s)
            for (path, leaf), s in zip(flat, spec_leaves)}


def port_specs_leaves(tree, specs):
    """The port's leaves beside their specs, in the same order."""
    leaves = list(port_leaves(tree))
    spec_leaves = [leaf for _, _, leaf in port_leaves(specs)]
    return [(p, was, leaf, s) for (p, was, leaf), s in zip(leaves,
                                                          spec_leaves)]


def hold_leaf_for_leaf(tree, specs, ref, mesh, gates_widened):
    """Every port leaf against its reference: shape and spec (without the
    layer axis where the port holds one layer), dtype, and once placed,
    the placements of its spec and JAX's shard shape as its local
    shape."""
    placed = with_sharding(tree, specs, mesh)
    pmesh = placement_mesh(mesh)
    seen = set()
    for (path, stacked, leaf, spec), (_, _, d) in zip(
            port_specs_leaves(tree, specs), port_leaves(placed)):
        assert path in ref, path
        seen.add(path)
        shape, dtype, rspec = ref[path]
        full = NamedSharding(JMESH, rspec).shard_shape(shape)
        if stacked:
            shape, rspec, full = shape[1:], P(*tuple(rspec)[1:]), full[1:]
        assert tuple(leaf.shape) == shape, path
        assert same(spec, rspec), (path, spec, rspec)
        name = path.split("/")[-1]
        want = "float32" if (gates_widened and name in GATES_FP32) else dtype
        assert str(leaf.dtype).replace("torch.", "") == want, path
        assert d.placements == to_placements(spec, pmesh), path
        assert tuple(d.to_local().shape) == tuple(full), path
    assert seen == set(ref)


ARCHS = ASSIGNED_ARCHS + ["llama3-3b"]
DECODE = ("decode_32k", 128, 32768)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch, mesh):
    shape_name = DECODE[0]
    jmodel = jax_build_model(jax_config_for_shape(arch, shape_name))
    params_sds = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    ref = jax_leaves(params_sds, jax_param_pspecs(params_sds, JMESH))
    cfg = config_for_shape(arch, shape_name)
    tree = init_shapes(build_model(cfg))
    assert all(t.is_meta for _, _, t in port_leaves(tree))
    hold_leaf_for_leaf(tree, param_pspecs(tree, mesh), ref, mesh,
                       gates_widened=cfg.weight_dtype != torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_tree_matches_reference(arch, mesh):
    shape_name, B, S = DECODE
    jmodel = jax_build_model(jax_config_for_shape(arch, shape_name))
    cache_sds = jax.eval_shape(lambda: jmodel.init_cache(B, S))
    ref = jax_leaves(cache_sds, jax_cache_pspecs(cache_sds, JMESH, B))
    cache = build_model(config_for_shape(arch, shape_name)).init_cache(
        B, S, device="meta")
    hold_leaf_for_leaf(cache, cache_pspecs(cache, mesh, B), ref, mesh,
                       gates_widened=False)


# ---------------------------------------------------------------------------
# a dim split over two mesh axes: pod-major, as JAX splits it
# ---------------------------------------------------------------------------

_JAX_SLICES = r'''
import json
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
devs = np.array(jax.devices()).reshape(2, 2, 4)
mesh = Mesh(devs, ("pod", "data", "model"))
index = NamedSharding(mesh, P(("pod", "data"))).devices_indices_map((8,))
print(json.dumps({f"{p}{d}{m}": index[devs[p, d, m]][0].start
                  for p in range(2) for d in range(2) for m in range(4)}))
'''


def test_tuple_entry_splits_pod_major_as_jax():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16")
    out = subprocess.run([sys.executable, "-c", _JAX_SLICES], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    starts = json.loads(out.stdout.strip().splitlines()[-1])
    spec = PSpec(("pod", "data"))
    for rank in range(16):
        torch.distributed.init_process_group(
            "fake", store=_fake_store(), rank=rank, world_size=16)
        try:
            m3 = make_debug_mesh(multi_pod=True, device_type="cpu")
            p, d, m = m3.get_coordinate()
            want = starts[f"{p}{d}{m}"]
            assert rank == p * 8 + d * 4 + m
            # on the mesh itself: two Shard(0), the pod first
            assert to_placements(spec, m3) == (Shard(0), Shard(0),
                                                Replicate())
            for on in (m3, placement_mesh(m3)):
                t = distribute_tensor(
                    torch.arange(8), on, to_placements(spec, on),
                    src_data_rank=None)
                assert t.to_local().tolist() == [want, want + 1], rank
            placed = with_sharding(torch.arange(8), spec, m3)
            assert placed.to_local().tolist() == [want, want + 1]
            with pytest.raises(ValueError):
                to_placements(PSpec(("data", "pod")), m3)
        finally:
            torch.distributed.destroy_process_group()


def _fake_store():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()
