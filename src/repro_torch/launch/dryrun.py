"""Multi-pod dry-run of the port: prove every (architecture x input-shape x
mesh) combination places and runs, the counterpart of
``repro.launch.dryrun``.

For each combination this builds the step (train_step / prefill /
serve_step) over params, optimizer state, inputs and cache placed on the
mesh as DTensors (``repro_torch.distributed.sharding``) of meta tensors (no
memory), and runs it once over a ``fake`` process group as wide as the
mesh: the stand-in for the JAX package's 512 host placeholder devices. The
run is the proof. It reports, with the JAX package's keys:

* ``flops``: the matmul FLOPs of one rank's local ops (what the JAX package
  reads from ``cost_analysis()`` of the partitioned module), and
  ``flops_global`` beside it, those of the same step run once more with
  nothing placed: the whole program's;
* ``bytes_accessed``: the bytes one rank's local ops read and write, each op
  apart (no fusion; views excluded);
* ``collective_bytes``: result bytes of the functional collectives
  (``_c10d_functional.*``) that DTensor issues, an all-reduce counted twice,
  as the JAX package counts them in its HLO (``collective_bytes``), and
  ``collective_sites``, the same bytes by kind, dtype, phase and the
  port's op that issued them (``StepCounter.collective_sites``; a row
  whose site starts with ``DTENSOR_SITE`` is a collective that DTensor's
  own sharding propagation chose, which no placed step should need);
* ``memory``: one rank's bytes of the arguments and of the outputs, from
  the local shapes, and ``temp_size_bytes``, the counterpart of XLA's
  temp buffer: the peak, over the step, of the bytes in live storages
  that the step allocated and that are not among its outputs at its end.
  An op's output counts once, by its storage's ``nbytes()``, when its
  storage first appears; it leaves the count when the storage is freed
  (autograd's saved tensors at the backward that frees them, an
  activation ``torch.utils.checkpoint`` dropped at once and counted again
  when recomputed). Views and in-place ops allocate nothing: arguments,
  and what the step writes into them in place (AdamW's moments, a decode
  step's cache), are not counted; a functional collective's output is an
  allocation. Allocations inside an op that no op returns (a library's
  workspace, a sort's scratch) are not seen. There is no compiled
  program, so ``generated_code_size_bytes`` is None.

``compile_s`` is the seconds to build and run the step on meta tensors.
Every count is taken on the CPU and is not a speed.

``cost_extrapolated(arch, shape, mesh, cfg_transform=None, donate=False)``
costs a variant of a step (a config transform, donated arguments) with the
JAX package's keys. The port keeps its layers as lists, so every layer is
counted: ``flops``, ``bytes_accessed``, ``collective_bytes`` and
``scan_length`` are the full-depth step's, nothing extrapolated, and
``u2_temp_bytes`` and ``u2_arg_bytes`` those of the u = 2 variant
(``_cost_variant``), as the JAX package's are. ``--cost-extrapolate`` adds
that block to each combination.

No process group is set up at import: ``run_one`` sets one up and destroys
it.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""
from __future__ import annotations

import argparse
import array
import contextlib
import json
import os
import re
import sys
import time
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ASSIGNED_ARCHS, config_for_shape, get_shape
from repro_torch.distributed.sharding import (PSpec, batch_pspec,
                                              cache_pspecs, local_bytes,
                                              param_pspecs, with_sharding)
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.common import init_shapes, tree_map, tree_tensors
from repro_torch.training.optimizer import AdamWConfig, init_adamw
from repro_torch.training.train_loop import make_train_step

# a placed step's FLOPs a rank over the JAX package's partitioned
# program's (``repro.launch.dryrun --cost-extrapolate``), at most
JAX_FLOPS_BOUND = 1.25
# a placed step's ``temp_size_bytes`` a rank over the JAX package's, at
# most (the port's are eager live bytes, unfused, where XLA's buffers are
# assigned after fusion)
JAX_TEMP_BOUND = 1.5

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "s32": 4,
                "u64": 8, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "f8e4m3": 1, "f8e5m2": 1}


def collective_bytes(hlo_text: str) -> dict:
    """Sum result bytes of collective ops in the (SPMD-partitioned) HLO.
    Convention: all-reduce counted 2x (ring send+recv), others 1x."""
    out = {"all-reduce": 0, "all-gather": 0, "reduce-scatter": 0,
           "all-to-all": 0, "collective-permute": 0}
    for line in hlo_text.splitlines():
        s = line.strip()
        m = re.match(r"^%?[\w.\-]+ = ([a-z0-9]+)\[([\d,]*)\]", s)
        if not m:
            continue
        op = None
        for cand in out:
            if re.search(rf"\b{cand}(-start|-done)?\(", s):
                op = cand
                break
        if op is None:
            continue
        dt, dims = m.group(1), m.group(2)
        nb = _DTYPE_BYTES.get(dt, 4)
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        out[op] += n * nb * (2 if op == "all-reduce" else 1)
    out["total"] = sum(v for k, v in out.items())
    return out


# ---------------------------------------------------------------------------
# counting: one dispatch mode over the step
# ---------------------------------------------------------------------------

# the functional collectives by the HLO op each stands for
_FUNCOL_KIND = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_to_all", "all-to-all"),
                ("broadcast", "collective-permute"))


_FAKE = torch._C._TorchDispatchModeKey.FAKE
_LIFT_FRESH = torch.ops.aten.lift_fresh.default

# the port's own source tree, and the two files of this module and the
# training loop that lie outside any placed op
_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_OUTER = {os.path.abspath(__file__),
          os.path.join(_PORT, "training", "train_loop.py")}
# where DTensor's sharding propagation redistributes an op's inputs: a
# collective issued below it is DTensor's own, not a placement the port
# states
_DISPATCH = os.path.join("torch", "distributed", "tensor", "_dispatch.py")
_CHECKPOINT = os.path.join("torch", "utils", "checkpoint.py")
DTENSOR_SITE = "DTensor's own dispatch"
_PATHS: dict = {}


def _path(code) -> str:
    """The absolute path of ``code``'s file (sys.path may hold a relative
    ``src``)."""
    path = _PATHS.get(code.co_filename)
    if path is None:
        path = _PATHS[code.co_filename] = os.path.abspath(code.co_filename)
    return path


def _frame_name(code, line: int) -> str:
    return f"{os.path.relpath(_path(code), _PORT)}:{line} {code.co_name}"


def collective_site(depth: int = 2) -> tuple:
    """(phase, site, own) of a collective being issued, read off the Python
    stack: ``phase`` "forward", "backward" or "recompute" (a checkpointed
    layer run again in the backward pass); ``site`` the ``depth``
    innermost frames of the port's placed ops (outside this module and the
    training loop; generator expressions skipped), innermost first, or,
    in the backward pass where no such frame is on the stack, the autograd
    node that runs; in the backward pass under anomaly mode, followed by
    the frames that made that node in the forward pass ("of ..."); ``own``
    True where DTensor's dispatch of an op (its sharding propagation)
    issued it rather than a placement the port states."""
    frames, own, recompute = [], False, False
    f = sys._getframe(1)
    while f is not None:
        path = _path(f.f_code)
        if path.startswith(_PORT) and path not in _OUTER:
            if len(frames) < depth and f.f_code.co_name != "<genexpr>":
                frames.append(_frame_name(f.f_code, f.f_lineno))
        elif not frames and path.endswith(_DISPATCH):
            own = True
        if path.endswith(_CHECKPOINT):
            recompute = True
        f = f.f_back
    node = torch._C._current_autograd_node()
    phase = ("forward" if node is None else
             "recompute" if recompute else "backward")
    if not frames:
        frames = [node.name() if node is not None else "(no port frame)"]
    if phase == "backward":
        # under ``torch.autograd.detect_anomaly`` a node keeps the stack
        # that made it in the forward pass
        made = [line for line in node.metadata.get("traceback_", ())
                if line.lstrip().startswith(f'File "{_PORT}')
                and not any(f'"{p}"' in line for p in _OUTER)
                and "in <genexpr>" not in line]
        frames += [_traced(line) for line in reversed(made)][:depth + 1]
    return phase, " < ".join(frames), own


_TRACED = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')


def _traced(line: str) -> str:
    """"file:line function" of a line of ``traceback.format_stack``."""
    path, no, fn = _TRACED.search(line).groups()
    return f"of {os.path.relpath(path, _PORT)}:{no} {fn}"


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(t) for t in tree)
    return 0


class StepCounter(TorchDispatchMode):
    """Counts one rank's work in a step as ``run_one`` reports it. An op on
    DTensors is handed on to DTensor (``NotImplemented``), which runs the
    rank's local ops, and the collectives it needs, with this mode still
    active: those, and ops on plain tensors, are what ``flops``,
    ``bytes_accessed``, ``collectives`` and the memory count. An op on
    another tensor subclass is not counted. FLOPs come from
    ``torch.utils.flop_counter``'s formulas, ``FlopCounterMode``'s own.

    Memory: each op output whose storage is new (not live in the count
    already, not one of the op's inputs') adds its ``nbytes()``, and a weak
    reference takes it off when the storage is freed. ``after[i]`` is the
    live total just after the i-th allocation; the total only falls
    between allocations, so these are the peaks. ``settle(out)`` then
    reads ``temp_bytes`` (the peak of the live bytes outside the step's
    outputs; ``temp_at`` the allocation that sets it), ``peak_bytes``
    (outputs included) and ``new_output_bytes`` (the outputs' storages that
    the step allocated; ``output_allocs`` their allocations)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = {kind: 0 for _, kind in _FUNCOL_KIND}
        self.sites = {}                 # (kind, dtype, phase, site, own)
        self.live_bytes = 0
        self.after = array.array("q")
        self._live = {}                 # storage cdata -> (i, bytes, ref)
        self.temp_bytes = self.peak_bytes = self.new_output_bytes = None
        self.temp_at, self.output_allocs = None, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # its local ops follow
        out = func(*args, **kwargs)
        if types or torch._C._get_dispatch_mode(_FAKE) is not None:
            # the fake tensors DTensor's sharding propagation learns an
            # output's shape from, and the factory calls that make them
            return out
        if not func.is_view:
            self._allocated(func, args, kwargs, out)
        packet = func._overloadpacket
        if func.namespace in ("_c10d_functional",
                              "_c10d_functional_autograd"):
            name = func.__name__
            for key, kind in _FUNCOL_KIND:
                if name.startswith(key):
                    n = _nbytes(out) * (2 if kind == "all-reduce" else 1)
                    self.collectives[kind] += n
                    dtype = str(next(tree_tensors(out)).dtype)[6:]
                    where = (kind, dtype) + collective_site()
                    self.sites[where] = self.sites.get(where, 0) + n
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view:
            self.bytes_accessed += (_nbytes(list(args))
                                    + _nbytes(list(kwargs.values()))
                                    + _nbytes(out))
        return out

    def _allocated(self, func, args, kwargs, out):
        inputs = None
        for t in tree_tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            if inputs is None:
                inputs = {x.untyped_storage()._cdata for x in tree_tensors(
                    (args, kwargs))}
            # an in-place op's result, or a view the schema does not mark
            # (``_unsafe_view``); ``lift_fresh`` hands on the new tensor
            # ``torch.tensor`` made
            if key in inputs and func is not _LIFT_FRESH:
                continue
            n = st.nbytes()
            self._live[key] = (len(self.after), n,
                               weakref.ref(st, self._freer(key)))
            self.live_bytes += n
            self.after.append(self.live_bytes)

    def _freer(self, key):
        def freed(_):
            _, n, _ = self._live.pop(key)
            self.live_bytes -= n
        return freed

    def settle(self, out):
        """Read the memory counts against the step's outputs ``out`` (a
        tree of tensors or DTensors), and stop following frees."""
        from torch.distributed.tensor import DTensor

        after = np.array(self.after, dtype=np.int64)
        sizes = np.zeros_like(after)
        for t in tree_tensors(out):
            local = t.to_local() if isinstance(t, DTensor) else t
            key = local.untyped_storage()._cdata
            if key in self._live:
                i, n, _ = self._live[key]
                sizes[i] = n
        self._live = {}
        outside = after - np.cumsum(sizes)
        self.temp_bytes = int(max(outside.max(initial=0), 0))
        self.peak_bytes = int(after.max(initial=0))
        self.new_output_bytes = int(sizes.sum())
        # which allocation sets ``temp_bytes``, and which are the outputs
        self.temp_at = int(outside.argmax()) if len(outside) else None
        self.output_allocs = set(np.flatnonzero(sizes).tolist())

    def collective_bytes(self) -> dict:
        out = dict(self.collectives)
        out["total"] = sum(out.values())
        return out

    def collective_sites(self) -> list:
        """The collective bytes by (kind, dtype, phase, site, own), as
        ``collective_site`` reads them: rows [kind, dtype, phase, site,
        bytes], largest first; ``DTENSOR_SITE`` (its site the port's frames
        that reached it, in brackets) where DTensor's own dispatch issued
        them."""
        rows = [[kind, dtype, phase,
                 f"{DTENSOR_SITE} [{site}]" if own else site, n]
                for (kind, dtype, phase, site, own), n in self.sites.items()]
        return sorted(rows, key=lambda r: (-r[4], r[:4]))


def sites_table(rows) -> str:
    """``collective_sites`` rows as a markdown table (bytes of one rank),
    then the bytes that DTensor's own dispatch issued."""
    lines = ["| kind | dtype | phase | site | bytes |",
             "| --- | --- | --- | --- | --- |"]
    lines += [f"| {kind} | {dtype} | {phase} | `{site}` | {n:.4e} |"
              for kind, dtype, phase, site, n in rows]
    own = sum(r[-1] for r in rows if r[3].startswith(DTENSOR_SITE))
    lines.append(f"{DTENSOR_SITE}: {own} B")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# input specs (meta tensors; never allocates)
# ---------------------------------------------------------------------------

def input_specs(cfg, shape):
    """Model inputs for the given InputShape (tokens/labels/frames...), as
    meta tensors."""
    B, S = shape.global_batch, shape.seq_len

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind == "train":
        batch = {"tokens": sds((B, S), torch.int32),
                 "labels": sds((B, S), torch.int32)}
        if cfg.is_encoder_decoder:
            batch["frames"] = sds((B, cfg.encoder_seq, cfg.d_model),
                                  cfg.activation_dtype)
        return batch
    if shape.kind == "prefill":
        out = {"tokens": sds((B, S), torch.int32)}
        if cfg.is_encoder_decoder:
            out["frames"] = sds((B, cfg.encoder_seq, cfg.d_model),
                                cfg.activation_dtype)
        return out
    # decode: one token against a seq_len-deep cache
    return {"token": sds((B, 1), torch.int32),
            "pos": sds((B,), torch.int32)}


def param_pspecs_like_opt(opt_state, p_specs):
    """Optimizer state: step replicated; moments shard like params."""
    return type(opt_state)(step=PSpec(), m=p_specs, v=p_specs)


# ---------------------------------------------------------------------------
# build the step per shape kind
# ---------------------------------------------------------------------------

def build_lowering(arch: str, shape_name: str, mesh, *, cfg_override=None,
                   shape=None, place: bool = True, max_len=None,
                   donate: bool = False):
    """(fn, args): the step of ``shape_name``'s kind (or of ``shape``, an
    ``InputShape`` given in its place) and its arguments, meta tensors, each
    a DTensor on ``mesh`` (plain with ``place`` False). ``fn(*args)`` runs
    the step; plain tensors made inside it (positions, masks, rope tables)
    are taken as replicated (``implicit_replication``). A prefill fills a
    cache of ``max_len`` slots (default: the shape's sequence length).

    The train step writes the params and AdamW moments it is given, and a
    decode step its cache, in place: the donated form
    (``donate_argnums=(0, 1)`` and ``(2,)`` in the JAX package). Without
    ``donate`` the step first copies those arguments and works on the
    copies, which it returns, so the caller's tensors survive as JAX's
    undonated buffers do; the counts see the copies."""
    from torch.distributed.tensor.experimental import implicit_replication

    shape = shape or get_shape(shape_name)
    cfg = cfg_override or config_for_shape(arch, shape_name)
    # the dry-run runs the plain path (the kernels are card-only)
    cfg = cfg.replace(use_pallas=False)
    model = build_model(cfg)
    B, S = shape.global_batch, shape.seq_len

    def placed(tree, specs):
        return with_sharding(tree, specs, mesh) if place else tree

    params = init_shapes(model)
    p_specs = param_pspecs(params, mesh)
    params_in = placed(params, p_specs)
    inputs = input_specs(cfg, shape)
    inputs_in = {k: placed(v, batch_pspec(mesh, B, extra_dims=v.ndim - 1))
                 for k, v in inputs.items()}

    if shape.kind == "train":
        opt = init_adamw(params)
        opt_in = placed(opt, param_pspecs_like_opt(opt, p_specs))
        step = make_train_step(model, AdamWConfig())

        def train_fn(params, opt_state, batch):
            if not donate:
                params, opt_state = _copies(params), _copies(opt_state)
            with implicit_replication():
                return step(params, opt_state, batch)
        return train_fn, (params_in, opt_in, inputs_in)

    if shape.kind == "prefill":
        max_len = max_len or S

        def prefill_fn(params, batch):
            with implicit_replication(), torch.no_grad():
                if cfg.is_encoder_decoder:
                    return model.prefill(params, batch["tokens"],
                                         batch["frames"], max_len=max_len)
                return model.prefill(params, batch["tokens"],
                                     max_len=max_len)
        return prefill_fn, (params_in, inputs_in)

    # decode
    cache = model.init_cache(B, S, device="meta")
    cache_in = placed(cache, cache_pspecs(cache, mesh, B))

    def serve_step(params, token, cache, pos):
        if not donate:
            cache = _copies(cache)
        with implicit_replication(), torch.no_grad():
            return model.decode_step(params, token, cache, pos)
    return serve_step, (params_in, inputs_in["token"], cache_in,
                        inputs_in["pos"])


def _copies(tree):
    """The tree's tensors copied (detached: a copy of a leaf is a leaf)."""
    return tree_map(lambda t: t.detach().clone(), tree)


# ---------------------------------------------------------------------------
# the costs of a variant: every layer is counted (no extrapolation)
# ---------------------------------------------------------------------------

def _scan_length(cfg) -> int:
    if cfg.arch_type == "hybrid":
        pat = len(cfg.block_pattern or ("rec", "rec", "attn"))
        return cfg.num_layers // pat
    prefix = cfg.first_k_dense if cfg.num_experts else 0
    return cfg.num_layers - prefix


def _cost_variant(cfg, u: int):
    """The config cut to u layer groups (the JAX package's unrolled cost
    variant: u scanned layers after the MoE models' dense prefix, u
    pattern units plus the tail of a hybrid, u encoder and u decoder
    layers of an encoder-decoder)."""
    if cfg.arch_type == "hybrid":
        pat = len(cfg.block_pattern or ("rec", "rec", "attn"))
        tail = cfg.num_layers % pat
        return cfg.replace(num_layers=pat * u + tail, unroll_layers=True)
    if cfg.is_encoder_decoder:
        return cfg.replace(num_layers=u, encoder_layers=u,
                           unroll_layers=True)
    prefix = cfg.first_k_dense if cfg.num_experts else 0
    return cfg.replace(num_layers=prefix + u, unroll_layers=True)


def _count_cost(arch, shape_name, mesh, cfg, donate: bool = False,
                whole: bool = True) -> dict:
    """One rank's counts of the placed step of ``cfg`` on ``mesh`` and, with
    ``whole``, ``flops_global``: those of the same step with nothing
    placed."""
    fn, args = build_lowering(arch, shape_name, mesh, cfg_override=cfg,
                              donate=donate)
    arg_bytes = local_bytes(args)
    out, counter = count_step(fn, args)
    out_bytes = local_bytes(out)
    del out, args
    flops_global = None
    if whole:
        flops_global = count_step(*build_lowering(
            arch, shape_name, mesh, cfg_override=cfg, place=False,
            donate=donate))[1].flops
    return {"flops": counter.flops, "flops_global": flops_global,
            "bytes": counter.bytes_accessed,
            "coll": counter.collective_bytes(),
            "sites": counter.collective_sites(),
            "temp_bytes": counter.temp_bytes, "arg_bytes": arg_bytes,
            "out_bytes": out_bytes}


def _extrapolated(arch, shape_name, mesh, cfg, full: dict,
                  donate: bool) -> dict:
    """The JAX package's ``cost_extrapolated`` block: the full-depth counts
    ``full`` (``_count_cost``), the u = 2 variant's memory."""
    u2 = _count_cost(arch, shape_name, mesh, _cost_variant(cfg, 2),
                     donate=donate, whole=False)
    return {"flops": full["flops"], "flops_global": full["flops_global"],
            "bytes_accessed": full["bytes"],
            "collective_bytes": dict(full["coll"]),
            "collective_sites": full["sites"],
            "scan_length": _scan_length(cfg),
            "u2_temp_bytes": u2["temp_bytes"],
            "u2_arg_bytes": u2["arg_bytes"],
            "note": "full depth: every layer counted (the port's layers "
                    "are lists), not extrapolated; u2_* from the u=2 "
                    "variant"}


def cost_extrapolated(arch, shape_name, mesh, cfg_transform=None,
                      donate: bool = False) -> dict:
    """The costs of a variant of (arch, shape) on ``mesh``: the config with
    ``cfg_transform`` applied, the train step's params and moments or the
    decode step's cache donated with ``donate``. ``mesh`` is a
    ``DeviceMesh`` over a ``fake`` group, as ``run_one`` builds it, or,
    where no process group is set up, the shape of a debug or production
    mesh (``mesh_shape``'s, say (16, 16)): a ``fake`` group as wide is
    then set up for the call and the mesh made in it. The JAX package's
    keys (``repro.launch.dryrun.cost_extrapolated``), plus
    ``flops_global``; see the module's docstring."""
    cfg = config_for_shape(arch, shape_name).replace(use_pallas=False)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    if isinstance(mesh, tuple):
        n = 1
        for v in mesh:
            n *= v
        with fake_process_group(n):
            return cost_extrapolated(arch, shape_name, _mesh_for(mesh),
                                     cfg_transform, donate)
    full = _count_cost(arch, shape_name, mesh, cfg, donate=donate)
    return _extrapolated(arch, shape_name, mesh, cfg, full, donate)


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def mesh_shape(*, multi_pod: bool = False, debug_mesh: bool = False):
    if debug_mesh:
        return (2, 2, 4) if multi_pod else (2, 4)
    return (2, 16, 16) if multi_pod else (16, 16)


def _mesh_for(shape):
    """The debug or production mesh of ``shape`` (``mesh_shape``'s), on the
    CPU, in the process group set up."""
    multi_pod = len(shape) == 3
    if shape == mesh_shape(multi_pod=multi_pod, debug_mesh=True):
        return make_debug_mesh(multi_pod=multi_pod, device_type="cpu")
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this one rank 0,
    for the span of the block: its collectives return at once and move no
    data. Raises if a process group is already set up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already set up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def count_step(fn, args, counter=None):
    """Run ``fn(*args)`` once under ``counter`` (a new ``StepCounter`` by
    default): (its output, the counter, settled against that output)."""
    # the first call of a function under ``torch._disable_dynamo`` (a meta
    # ``arange``, ``torch.utils.checkpoint``) imports ``torch._dynamo``,
    # whose frames, left in a reference cycle, hold the caller's tensors
    # until the collector runs: imported first, the count does not depend
    # on whether the step is the process's first
    import torch._dynamo  # noqa: F401
    counter = counter or StepCounter()
    with counter:
        out = fn(*args)
    counter.settle(out)
    return out, counter


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            debug_mesh: bool = False, verbose: bool = True,
            extrapolate: bool = False, cfg_override=None) -> dict:
    t0 = time.time()
    shp = mesh_shape(multi_pod=multi_pod, debug_mesh=debug_mesh)
    n_dev = 1
    for v in shp:
        n_dev *= v
    cfg = (cfg_override or config_for_shape(arch, shape_name)).replace(
        use_pallas=False)
    with fake_process_group(n_dev):
        mesh = _mesh_for(shp)
        full = _count_cost(arch, shape_name, mesh, cfg)
        extra = (_extrapolated(arch, shape_name, mesh, cfg, full, False)
                 if extrapolate else None)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(v) for v in shp),
        "devices": n_dev,
        "flops": full["flops"],
        "flops_global": full["flops_global"],
        "bytes_accessed": full["bytes"],
        "collective_bytes": full["coll"],
        "collective_sites": full["sites"],
        "memory": {
            "argument_size_bytes": full["arg_bytes"],
            "output_size_bytes": full["out_bytes"],
            "temp_size_bytes": full["temp_bytes"],
            "generated_code_size_bytes": None,
        },
        "compile_s": round(time.time() - t0, 2),
    }
    if extra is not None:
        result["extrapolated"] = extra
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x mesh={result['mesh']}: "
              f"OK ({result['compile_s']}s)")
        print(f"  memory: {result['memory']}")
        print(f"  flops={result['flops']:.3e} "
              f"flops_global={result['flops_global']:.3e} "
              f"bytes={result['bytes_accessed']:.3e}")
        coll = {k: f"{v:.2e}" for k, v in result["collective_bytes"].items()}
        print(f"  collectives: {coll}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="train_4k",
                    help="input shape name or 'all'")
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape)")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="small 2x4 mesh (tests)")
    ap.add_argument("--out", default="",
                    help="write JSON results to this path")
    ap.add_argument("--cost-extrapolate", action="store_true",
                    help="add cost_extrapolated's block (full depth, and "
                         "the u=2 variant's memory)")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or args.arch == "all") \
        else [args.arch]
    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"] \
        if (args.all or args.shape == "all") else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    results, failures = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(run_one(
                        arch, shape, multi_pod=mp,
                        debug_mesh=args.debug_mesh,
                        extrapolate=args.cost_extrapolate))
                except Exception as e:  # noqa: BLE001
                    failures.append({"arch": arch, "shape": shape,
                                     "multi_pod": mp, "error": str(e)[:500]})
                    print(f"[dryrun] FAIL {arch} x {shape} x mp={mp}: "
                          f"{str(e)[:200]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures}, f,
                      indent=1)
    print(f"\n[dryrun] {len(results)} ok, {len(failures)} failed")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
