"""Sharding rules of the port: map a model's params, optimizer state and
decode cache to specs, and specs to DTensor placements on a ``DeviceMesh``.
The counterpart of ``repro.distributed.sharding``, rule for rule.

Strategy (Megatron-style TP x DP, MoE expert-parallel over the `model`
axis):
  * batch axes       -> data axes ("pod","data") when divisible, else None
  * attention fused-QKV / FFN-in hidden dim, vocab dim -> "model"
  * attention out / FFN-out contraction dim            -> "model"
  * expert axis of MoE expert weights                  -> "model" (EP)
  * KV cache heads / MLA latent rank / SSM heads / LRU width -> "model"
  * norms, scalars, small vectors -> replicated

A spec has two forms. ``PSpec`` is the JAX package's per-tensor-dim form:
one entry per tensor dim, an axis name, a tuple of names or None, with a
one-name tuple held as the name, as ``PartitionSpec`` holds it.
``to_placements`` turns it into DTensor's per-mesh-dim form: ``Shard(d)``
on each mesh dim whose name shards tensor dim d, ``Replicate()`` elsewhere.

Rules are NAME-BASED over tree paths, so one table covers every family.
The port's trees keep a list of per-layer dicts where the JAX package
stacks a leading layer axis (``repro_torch.models.convert``). A param's
rule maps its trailing dims, so a list element gets the stacked leaf's spec
without its leading None. A cache is recognised as stacked by name; where
the port holds such a cache as a list of layers (the hybrid's ``units``),
each element gets the stacked leaf's spec without its leading None.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.models.common import tree_tensors

MODEL_AXIS = "model"

# cache keys whose leaves the JAX package stacks over layers
_STACKED_CACHE = ("scanned", "units", "self", "cross_k", "cross_v")


class PSpec(tuple):
    """A per-tensor-dim sharding spec, ``PartitionSpec``'s form: each entry
    an axis name, a tuple of names (the dim split over them, the first
    major) or None. A one-name tuple is held as the name and an empty one
    as None, so specs compare equal where ``PartitionSpec``s do."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return "PSpec" + tuple.__repr__(tuple(self))


def _axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


# ---------------------------------------------------------------------------
# rule table: (path substring match, rank) -> spec builder
# each entry maps the TRAILING dims of the unstacked parameter
# ---------------------------------------------------------------------------

def _param_rule(name: str, path: str) -> Optional[Tuple[Optional[str], ...]]:
    """Returns the trailing-dims partition (tuple of axis names/None) for a
    parameter leaf, or None for full replication."""
    m = MODEL_AXIS
    # embeddings / unembeddings
    if name == "embed":
        return (m, None)                      # (V, d) vocab-parallel
    if name == "lm_head":
        return (None, m)                      # (d, V)
    # attention projections
    if name in ("wq", "wk", "wv"):
        return (None, m)                      # (d, H*hd)
    if name == "wo":
        return (m, None)                      # (H*hd, d)
    # MLA
    if name == "w_dkv":
        return (None, None)                   # latent proj small; replicate
    if name in ("w_uk", "w_uv"):
        return (None, m)                      # (rank, H*hd)
    # FFN
    if name in ("w_in", "w_gate"):
        if "moe" in path and "shared" not in path:
            return (m, None, None)            # (E, d, f) expert-parallel
        if "mixer" in path and "moe" not in path:
            return (None, m)                  # ssm in_proj (d, X)
        return (None, m)                      # (d, f)
    if name == "w_out":
        if "moe" in path and "shared" not in path:
            return (m, None, None)            # (E, f, d)
        return (m, None)                      # (f, d)
    if name == "router":
        return None                           # replicate (tiny, all-to-all)
    # hybrid RG-LRU
    if name in ("w_x", "w_y"):
        return (None, m)                      # (d, W)
    if name in ("w_input_gate", "w_rec_gate"):
        return (None, m)                      # (W, W) shard output dim
    # convs / per-channel vectors: shard the channel (lane) dim
    if name == "conv_w":
        return (None, m)                      # (k, channels)
    if name in ("lambda_param", "norm_w"):
        return None                           # small; replicate
    return None


def _spec_for_leaf(path_str: str, ndim: int) -> PSpec:
    parts = [p for p in path_str.split("/") if p]
    name = parts[-1] if parts else ""
    rule = _param_rule(name, path_str)
    if rule is None:
        return PSpec()
    lead = ndim - len(rule)
    if lead < 0:
        return PSpec()
    return PSpec(*([None] * lead + list(rule)))


def sanitize_spec(spec: PSpec, shape, mesh) -> PSpec:
    """Drop sharding on any dim the mesh axes do not divide (a placed
    tensor's dims must divide exactly, as the JAX package's explicit
    in_shardings require)."""
    sizes = _axis_sizes(mesh)
    out = []
    for i, entry in enumerate(list(spec) + [None] * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= sizes[a]
        out.append(entry if shape[i] % size == 0 and shape[i] >= size
                   else None)
    return PSpec(*out)


# ---------------------------------------------------------------------------
# trees: nested dicts, lists and named tuples of tensors
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path=(), in_list_of=None):
    """``fn(path string, leaf, the key of the innermost list that holds the
    leaf or None)`` over a tree, keeping its containers."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),), in_list_of)
                for k, v in tree.items()}
    if isinstance(tree, list):
        key = path[-1] if path else None
        return [_map_with_path(fn, v, path + (str(i),), key)
                for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,), in_list_of)
                            for f, v in zip(tree._fields, tree)))
    return fn("/".join(path), tree, in_list_of)


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (``PSpec`` leaves)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, v, s) for v, s in zip(tree, specs)))
    return fn(tree, specs)


def param_pspecs(params: Any, mesh=None) -> Any:
    """PSpec tree matching ``params`` (any tree of tensors, meta ones
    too)."""
    def one(path, leaf, _):
        spec = _spec_for_leaf(path, len(leaf.shape))
        return sanitize_spec(spec, leaf.shape, mesh) if mesh is not None \
            else spec
    return _map_with_path(one, params)


# ---------------------------------------------------------------------------
# caches & activations
# ---------------------------------------------------------------------------

def cache_pspecs(cache: Any, mesh, global_batch: int) -> Any:
    """Decode-cache specs. Heads/latent/width dims go to `model`; the batch
    dim goes to the data axes when divisible (else replicated — e.g. the
    batch=1 long-context shape)."""
    sizes = _axis_sizes(mesh)
    da = data_axes(mesh)
    dp = 1
    for a in da:
        dp *= sizes[a]
    batch_spec = da if (da and global_batch % dp == 0
                        and global_batch >= dp) else None
    m = MODEL_AXIS

    def stacked_spec(ps, shape):
        nd = len(shape)
        # identify the stacked-layer leading axis by convention: caches are
        # built stacked, so rank>=3 arrays start with (L, B, ...) except
        # prefix/tail lists whose leaves start with (B, ...).
        stacked = any(s in ps for s in _STACKED_CACHE) \
            and "prefix" not in ps and "tail" not in ps
        lead = [None] if stacked else []
        body = [batch_spec]
        rest = nd - len(lead) - 1
        mdl = sizes[m]
        off = len(lead) + 1                    # index of first body dim
        if "c_kv" in ps:                       # (.., T, rank)
            body += [None] * (rest - 1) + [m]
        elif "k_rope" in ps:                   # (.., T, rope_dim) small
            body += [None] * rest
        elif "ssm" in ps and rest == 3:        # (H, P, N)
            body += [m, None, None]
        elif ps.endswith("conv") or "conv" in ps.split("/")[-1]:
            body += [None] * (rest - 1) + [m]  # (k-1, channels)
        elif ps.endswith("h"):                 # LRU state (B, W)
            body += [None] * (rest - 1) + [m]
        elif rest == 3:                        # KV cache (T, Hkv, D)
            hkv = shape[off + 1]
            T = shape[off]
            if hkv % mdl == 0:
                body += [None, m, None]        # head-parallel
            elif T % mdl == 0:
                body += [m, None, None]        # context-parallel fallback
            else:
                body += [None, None, None]
        else:
            body += [None] * rest
        return sanitize_spec(PSpec(*(lead + body)), shape, mesh)

    def one(ps, leaf, in_list_of):
        shape = tuple(leaf.shape)
        if in_list_of in _STACKED_CACHE:
            # one layer of a cache the JAX package stacks: its spec there,
            # without the layer axis
            return PSpec(*stacked_spec(ps, (1,) + shape)[1:])
        return stacked_spec(ps, shape)
    return _map_with_path(one, cache)


def batch_pspec(mesh, global_batch: int, extra_dims: int = 1) -> PSpec:
    da = data_axes(mesh)
    sizes = _axis_sizes(mesh)
    dp = 1
    for a in da:
        dp *= sizes[a]
    if da and global_batch % dp == 0 and global_batch >= dp:
        return PSpec(da, *([None] * extra_dims))
    return PSpec(None, *([None] * extra_dims))


def logits_pspec(mesh, global_batch: int,
                 vocab_size: Optional[int] = None) -> PSpec:
    bs = batch_pspec(mesh, global_batch, extra_dims=0)
    vocab_axis = MODEL_AXIS
    if vocab_size is not None and vocab_size % _axis_sizes(mesh)[MODEL_AXIS]:
        vocab_axis = None                      # e.g. whisper's 51865
    return PSpec(bs[0] if len(bs) else None, None, vocab_axis)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placement_mesh(mesh):
    """The mesh the port places DTensors on: ``mesh`` itself, or, where it
    has two data axes ("pod" and "data"), its 2-D view with them flattened
    into one dim named "pod+data", pod-major. The rules never split a dim
    over one data axis alone, so the view places every spec as ``mesh``
    would. It is there for DTensor's planner: a dim split over two mesh
    dims sends each op's sharding propagation through a graph search over
    shard orders that took minutes an op in a dry-run."""
    da = data_axes(mesh)
    if len(da) < 2:
        return mesh
    name = "+".join(da)
    mesh[da]._flatten(name)
    return mesh[(name,) + tuple(a for a in mesh.mesh_dim_names
                                if a not in da)]


def to_placements(spec: PSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where the mesh dim's axes (a "+"-joined name is a
    flattened run of axes, ``placement_mesh``) shard tensor dim d, else
    ``Replicate()``. A dim split over several axes is split over them in
    the mesh's order, the first major, which is DTensor's order for two
    ``Shard(d)`` of one d and the JAX package's for a tuple entry; an entry
    that names its axes in another order, or that a mesh dim covers only
    in part, raises."""
    from torch.distributed.tensor import Replicate, Shard

    dims = [tuple(n.split("+")) for n in mesh.mesh_dim_names]
    out = [Replicate() for _ in dims]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        hit = [i for i, ax in enumerate(dims) if set(ax) & set(axes)]
        if sum((dims[i] for i in hit), ()) != axes:
            raise ValueError(
                f"spec entry {entry!r} does not match the mesh dims "
                f"{mesh.mesh_dim_names} in order: DTensor splits a dim over "
                f"whole mesh dims, major to minor in mesh order")
        for i in hit:
            out[i] = Shard(d)
    return tuple(out)


def with_sharding(tree: Any, specs: Any, mesh) -> Any:
    """The tree with each leaf a DTensor placed by its spec
    (``to_placements``) on ``placement_mesh(mesh)``: the counterpart of
    attaching ``NamedSharding``s to a ``ShapeDtypeStruct`` tree. Meta
    leaves stay meta. Every rank is taken to hold the same full leaf (one
    seed), so each keeps its own shard and nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    pmesh = placement_mesh(mesh)

    def place(leaf, spec):
        return distribute_tensor(leaf, pmesh, to_placements(spec, pmesh),
                                 src_data_rank=None)
    return _zip_map(place, tree, specs)


def local_bytes(tree: Any) -> int:
    """Bytes of one rank's shards of a tree of DTensors (plain tensors
    whole)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tree_tensors(tree):
        local = t.to_local() if isinstance(t, DTensor) else t
        total += local.numel() * local.element_size()
    return total

