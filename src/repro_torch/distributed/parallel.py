"""What the models do on DTensors: each placed op states the placement of
its inputs and of its output, and runs on each rank's own shard, so that a
placed step splits its work over the mesh as the JAX package's
partitioned program does (Megatron TP x DP, experts over "model"), in every
torch release alike. The plain path never comes here: each function is
reached only with DTensor operands.

Layout of a placed step: the residual stream (B, S, d) is split over the
batch on the data axes and replicated over "model".

* ``linear``: ``x @ w`` by where ``w`` is split. Column-parallel (``w``
  split on its output dim: ``wq``/``wk``/``wv``, ``w_in``/``w_gate``,
  ``w_x``/``w_y``, ``w_uk``/``w_uv``, the SSM in-projection, the RG-LRU
  gates, ``lm_head``): the input replicated over "model", the output
  split on its last dim. Row-parallel (``w`` split on its input dim:
  ``wo``, ``w_out``): the input split on its last dim, the partial sums
  reduced once by an all-reduce. No weight is gathered.
* ``split_dim`` and ``merge_dims``: a split of heads viewed shard by
  shard; ``divide_dim``: a split that does not divide the heads,
  gathered; ``kv_heads``: k and v of a whole sequence gathered only among
  the ranks whose query heads read each kv head (``kv_cache_layout``
  takes a prefill's cache out of that form).
* ``local_attention``: attention on each rank's rows and query heads; each
  rank takes the kv heads its query heads read. Query heads that the
  model axis does not divide take the JAX partitioner's padded share,
  ceil(H / m) a rank, their output a partial sum. Over a cache whose slots
  are split (the context-parallel fallback of ``cache_pspecs``), each
  rank attends its own slots and three small all-reduces combine the
  partial (max, sum, product). Where the data axes leave the batch whole
  (long_500k's one row), MLA's decode attends a part of the slots on each
  of their ranks (``split_slots``).
* ``local_conv``, ``route``, ``moe_experts``, ``moe_capacity``,
  ``ssd_heads``, ``rms_norm``: the depthwise conv on each rank's channels,
  the MoE router on each rank's rows, the dense and the capacity expert
  dispatch on each rank's experts (the dense one's partial sums, the
  shared experts' among them, reduced once in fp32; the capacity
  dispatch's routing that of the whole batch; with the EP constraint its
  buffer's rows split over the data axes too), the SSD on each rank's
  heads, an RMSNorm over a split dim; ``ssd_parts``: Mamba-2's fused
  columns exchanged so that each rank holds what its heads read;
  ``batch_mean``: a mean over the batch's rows (the load-balance loss).
* ``vocab_parallel_nll``: the cross entropy of logits sharded over the
  vocab (``logits_pspec``), Megatron's vocab-parallel form: three
  all-reduces of (B, S) over the vocab's mesh dims; the logits are never
  gathered, and the backward pass is local. ``rows_nll``: that of logits
  whose vocab is whole, on each rank's rows.
* ``embedding``: the vocab-parallel lookup, ``stack_layers``: a prefill's
  per-layer caches stacked shard by shard, ``cache_layout``: a prefill's
  cache placed as ``cache_pspecs`` places a decode cache, ``write_slots``:
  a decode step's in-place cache write on each rank's own shard, and
  ``local_scan``: the RG-LRU recurrence on each rank's rows and lanes.

Gradients: each function brings the gradient of each input to the input's
own placement where it leaves (``_grad_to``): an activation's partial
sums over "model" are all-reduced there, a weight's over the batch's mesh
dims. A mesh dim of size 1 holds no partial sum and moves nothing. AdamW
brings the rest (a norm's weight, left a partial sum by DTensor's own
rules) to its param's placement (``placed_as``) and sums the norm's
squares over each gradient's own split (``global_norm``). No collective of
a placed step is left to DTensor's own sharding propagation
(``launch.dryrun.collective_site`` tells them apart).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

MODEL_AXIS = "model"


def _as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    """``t`` itself if it is a DTensor, else a plain tensor that every rank
    holds whole (as ``implicit_replication`` takes it), replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _mesh_of(*ts):
    return next(t for t in ts if isinstance(t, DTensor)).device_mesh


def _is_shard(p, dim: Optional[int] = None) -> bool:
    return isinstance(p, Shard) and (dim is None or p.dim == dim)


def _shard_dims(placements, dim: int) -> List[int]:
    """The mesh dims whose placement shards tensor dim ``dim``."""
    return [i for i, p in enumerate(placements) if _is_shard(p, dim)]


def _offset(mesh, mesh_dims: List[int], global_len: int) -> Tuple[int, int]:
    """(this rank's first index, its length) of a dim of ``global_len``
    split evenly over ``mesh_dims``, the first major."""
    idx, n = 0, 1
    coord = mesh.get_coordinate()
    for d in mesh_dims:
        idx = idx * mesh.size(d) + coord[d]
        n *= mesh.size(d)
    size = global_len // n
    return idx * size, size


def _model_dim(mesh) -> Optional[int]:
    """The mesh dim named "model" where it splits (size > 1), else None."""
    names = mesh.mesh_dim_names or ()
    if MODEL_AXIS in names:
        i = names.index(MODEL_AXIS)
        if mesh.size(i) > 1:
            return i
    return None


def _partial(mesh, i: int, op: str = "sum"):
    """A partial sum (or max) over mesh dim ``i``; nothing is partial over
    a mesh dim of size 1."""
    return Partial(op) if mesh.size(i) > 1 else Replicate()


def _grad_placements(placements) -> tuple:
    return tuple(Replicate() if isinstance(p, Partial) else p
                 for p in placements)


def _reduced(t: DTensor) -> DTensor:
    """``t`` with every partial mesh dim reduced (an all-reduce)."""
    target = _grad_placements(t.placements)
    if target == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, target)


class _GradTo(torch.autograd.Function):
    """The identity, whose backward pass brings the gradient to
    ``placements``: partial sums reduced, a split kept."""

    @staticmethod
    def forward(ctx, t, placements):
        ctx.placements = placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and tuple(grad.placements) != \
                ctx.placements:
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad, None


def _grad_to(t: DTensor) -> DTensor:
    """``t``, its gradient brought to its own placement where it leaves."""
    if not t.requires_grad:
        return t
    return _GradTo.apply(t, _grad_placements(t.placements))


def _local_map(fn, out, ins, grads, mesh):
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)


def _rows(t: DTensor, last: int) -> list:
    """Per mesh dim: ``t``'s split of a leading dim (the batch) there, else
    Replicate."""
    return [p if isinstance(p, Shard) and p.dim < last else Replicate()
            for p in t.placements]


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def _roles(x: DTensor, w: DTensor):
    """Per mesh dim, how ``x @ w`` splits there: (x's placement in, the
    output's, x's gradient's, w's gradient's)."""
    mesh, last = x.device_mesh, x.ndim - 1
    roles = []
    for i, wp in enumerate(w.placements):
        if _is_shard(wp, w.ndim - 1):               # column
            roles.append((Replicate(), Shard(last), _partial(mesh, i), wp))
        elif _is_shard(wp):                         # row
            roles.append((Shard(last), _partial(mesh, i), Shard(last), wp))
        else:
            xp = x.placements[i]
            rows = xp if isinstance(xp, Shard) and xp.dim < last \
                else Replicate()
            roles.append((rows, rows, rows, _partial(mesh, i)
                          if isinstance(rows, Shard) else Replicate()))
    return roles


def linear(x: torch.Tensor, *ws: torch.Tensor):
    """``x @ w`` for each ``w`` (K, N) placed by the rules: over each mesh
    dim that splits ``w``'s output dim, ``x`` replicated and the output
    split on its last dim (column-parallel); over one that splits its
    input dim, ``x`` split on its last dim and the partial sums
    all-reduced (row-parallel); over one that replicates ``w``, ``x``'s
    split of its rows kept (the batch) and the product local. The weights
    stay as placed. Products of one input that split alike (``wq``,
    ``wk``, ``wv``; ``w_in``, ``w_gate``) run in one region, so the
    partial sums of the input's gradient are all-reduced once. One
    product's output for one ``w``, else a tuple."""
    mesh = _mesh_of(x, *ws)
    x = _as_dtensor(x, mesh)
    ws = [_as_dtensor(w, mesh) for w in ws]
    roles = [_roles(x, w) for w in ws]
    if any(r != roles[0] for r in roles[1:]):
        out = tuple(linear(x, w) for w in ws)
        return out if len(out) > 1 else out[0]
    x_in, out, x_grad, _ = (list(t) for t in zip(*roles[0]))
    w_grads = [[r[3] for r in role] for role in roles]

    def products(a, *bs):
        return tuple(a @ b for b in bs)
    run = _local_map(products, tuple([out] * len(ws)),
                     (x_in,) + tuple(tuple(w.placements) for w in ws),
                     (x_grad,) + tuple(w_grads), mesh)
    ys = tuple(_reduced(y) for y in run(_grad_to(x),
                                        *(_grad_to(w) for w in ws)))
    return ys if len(ys) > 1 else ys[0]


# ---------------------------------------------------------------------------
# views of a split of heads
# ---------------------------------------------------------------------------

def divide_dim(t: DTensor, dim: int, count: int) -> DTensor:
    """``t``, made whole over each mesh dim of the split of tensor dim
    ``dim`` that would divide ``count`` unevenly (an all-gather), so that
    ``dim`` views as (count, ...). Nothing moves where ``count``
    divides."""
    mesh, dim = t.device_mesh, dim % t.ndim
    target, split = list(t.placements), 1
    for i, p in enumerate(target):
        if _is_shard(p, dim):
            if count % (split * mesh.size(i)):
                target[i] = Replicate()
            else:
                split *= mesh.size(i)
    if tuple(target) == tuple(t.placements):
        return t
    return t.redistribute(mesh, target)


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, n = [], 1
    for size in reversed(shape):
        strides.append(n)
        n *= size
    return tuple(reversed(strides))


def _view(t: DTensor, local_shape, shape, placements) -> DTensor:
    """``t``'s local shard viewed as ``local_shape``, as a DTensor of
    ``shape`` and ``placements`` with the strides a plain reshape gives
    (DTensor's view rule may keep another stride for a dim of size 1, the
    (B, 1, H*D) attention output of a decode step, and ``at::matmul``
    reads it to decide whether to fold a (B, 1, K) operand into one GEMM
    or run a batched one, which rounds otherwise)."""
    local = t.to_local().reshape(local_shape)
    return DTensor.from_local(local, t.device_mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def split_dim(t: DTensor, dim: int, sizes: Sequence[int]) -> DTensor:
    """``t`` with dim ``dim`` viewed as ``sizes``: a split of it that
    divides ``sizes[0]`` becomes a split of the first new dim, one that
    does not is gathered first (``divide_dim``)."""
    dim = dim % t.ndim
    t = divide_dim(t, dim, sizes[0])
    local = t.to_local()
    rest = 1
    for s in sizes[1:]:
        rest *= s
    local_shape = (local.shape[:dim] + (local.shape[dim] // rest,)
                   + tuple(sizes[1:]) + local.shape[dim + 1:])
    shape = t.shape[:dim] + tuple(sizes) + t.shape[dim + 1:]
    extra = len(sizes) - 1
    placements = [Shard(p.dim + extra) if _is_shard(p) and p.dim > dim
                  else p for p in t.placements]
    return _view(t, local_shape, shape, placements)


def merge_dims(t: DTensor, dim: int) -> DTensor:
    """``t`` with dims ``dim`` and ``dim + 1`` viewed as one; a split of
    ``dim`` becomes a split of the merged dim (``dim + 1`` is never
    split)."""
    dim = dim % t.ndim
    local = t.to_local()
    local_shape = (local.shape[:dim] + (-1,) + local.shape[dim + 2:])
    shape = t.shape[:dim] + (t.shape[dim] * t.shape[dim + 1],) \
        + t.shape[dim + 2:]
    placements = [Shard(p.dim - 1) if _is_shard(p) and p.dim > dim
                  else p for p in t.placements]
    return _view(t, local_shape, shape, placements)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _head_share(H: int, m: int, c: int) -> Tuple[int, int]:
    """The query heads [lo, hi) of rank ``c`` of ``m``: H / m where m
    divides H, else the partitioner's padded share, ceil(H / m) each (the
    last ranks hold fewer, or none)."""
    n = -(-H // m)
    lo = min(c * n, H)
    return lo, min(lo + n, H)


def _kv_for(k: torch.Tensor, H: int, heads: Sequence[int]) -> torch.Tensor:
    """The kv heads (dim 2 of k, all ``Hkv`` of them) that query heads
    ``heads`` (ascending) of H read, in an order in which query head j of
    ``heads`` reads kv head j // (len(heads) / n) of the n taken: a run of
    them where ``heads`` is a run that covers whole groups or lies in one,
    else one a query head."""
    G = H // k.shape[2]
    lo, hi = heads[0], heads[-1] + 1
    a, b = lo // G, (hi - 1) // G + 1
    if list(heads) == list(range(lo, hi)) and (
            b - a == 1 or (lo % G == 0 and hi % G == 0)):
        return k[:, :, a:b]
    idx = torch.tensor([h // G for h in heads], device=k.device)
    return k.index_select(2, idx)


def local_attention(fn, q, k, v, mask, *, partial=None, **kw):
    """``fn(q, k, v, mask, **kw)`` (an attention over q (B, S, H, D) and k,
    v (B, T, Hkv, D), mask None or broadcasting to (B, 1, S, T)) run on each
    rank's own shard, as the JAX package's partitioner runs it: the batch
    split as q's is, and over "model" each rank's query heads (H / m, or
    the padded share where m does not divide H: ceil(H / m) heads on every
    rank, padded with repeats of the last, the output a partial sum over
    "model" with zeros in the other heads) against the kv heads
    they read (split with them where m divides Hkv, else taken whole and
    selected). Where the slots of k and v are split (a context-parallel
    decode cache), ``partial(q, k, v, mask)`` gives each rank's (max, sum,
    product) over its slots, combined as ``context_attention`` does."""
    mesh = _mesh_of(q, k, v)
    q, k, v = (_as_dtensor(t, mesh) for t in (q, k, v))
    ctx = [i for i in range(mesh.ndim) if mesh.size(i) > 1
           and (_is_shard(k.placements[i], 1)
                or _is_shard(v.placements[i], 1))]
    if ctx:
        return context_attention(partial, q, k, v, mask, ctx)
    H, Hkv = q.shape[2], k.shape[2]
    batch = [Shard(0) if _is_shard(p, 0) else Replicate()
             for p in q.placements]
    hd = _model_dim(mesh)
    if hd is not None and _is_shard(q.placements[hd], 0):
        hd = None
    m = mesh.size(hd) if hd is not None else 1
    q_in, kv_in, out, q_grad, kv_grad = (list(batch) for _ in range(5))
    even = H % m == 0
    kv_split = even and Hkv % m == 0
    if hd is not None:
        q_in[hd] = q_grad[hd] = Shard(2) if even else Replicate()
        kv_in[hd] = kv_grad[hd] = Shard(2) if kv_split else Replicate()
        if not kv_split:
            kv_grad[hd] = Partial()
        if not even:
            q_grad[hd] = Partial()
        out[hd] = Shard(2) if even else Partial()
    c = mesh.get_coordinate()[hd] if hd is not None else 0

    def attend(q_, k_, v_, mask_):
        if kv_split or m == 1:
            return fn(q_, k_, v_, mask_, **kw)
        n = q_.shape[2] if even else -(-H // m)
        heads = range(c * n, (c + 1) * n)
        if even:
            return fn(q_, _kv_for(k_, H, heads), _kv_for(v_, H, heads),
                      mask_, **kw)
        # the partitioner's padding: every rank runs n heads, a padded one
        # a repeat of head H - 1 whose output is dropped, so that every
        # rank's gradient reaches q, k and v by the same collectives
        lo, hi = _head_share(H, m, c)
        heads = [min(h, H - 1) for h in heads]
        q_own = q_[:, :, lo:hi] if hi - lo == n else q_.index_select(
            2, torch.tensor(heads, device=q_.device))
        full = torch.zeros(q_.shape[:3] + v_.shape[3:], dtype=q_.dtype,
                           device=q_.device)
        full[:, :, lo:hi] = fn(q_own, _kv_for(k_, H, heads),
                               _kv_for(v_, H, heads), mask_,
                               **kw)[:, :, :hi - lo]
        return full

    mask_in = None
    if isinstance(mask, DTensor):
        mask_in = [b if mask.shape[0] == q.shape[0] else Replicate()
                   for b in batch]
    # a list is one output's placements (a tuple would be one per output)
    run = _local_map(attend, out, (q_in, kv_in, kv_in, mask_in),
                     (q_grad, kv_grad, kv_grad, mask_in), mesh)
    return run(_grad_to(q), _grad_to(k), _grad_to(v), mask)


def local_heads(fn, split, whole, mask, *args, partial=None):
    """``fn(*split, whole, mask, *args)`` (MLA's attention: ``split``
    (B, ., H, .) tensors, q's and then k's and v's, ``whole`` (B, T, r)
    shared by the heads, mask broadcasting to (B, H, S, T)) -> (B, S, H,
    .), on each rank's rows and its heads over "model" (all of them where
    the model axis does not divide H). Where ``whole``'s slots are split
    (``split_slots``), ``partial`` (same arguments) gives each rank's
    (max, sum, product) over its slots, (B, H, S) and (B, H, S, D), and
    ``combine_parts`` joins them (no gradient: a decode step)."""
    mesh = _mesh_of(*split)
    split = [_as_dtensor(t, mesh) for t in split]
    whole = _as_dtensor(whole, mesh)
    batch = [Shard(0) if _is_shard(p, 0) else Replicate()
             for p in split[0].placements]
    ctx = [i for i in range(mesh.ndim)
           if mesh.size(i) > 1 and _is_shard(whole.placements[i], 1)]
    hd = _model_dim(mesh)
    heads = list(batch)
    if (hd is not None and not _is_shard(batch[hd])
            and split[0].shape[2] % mesh.size(hd) == 0):
        heads[hd] = Shard(2)

    def own(t, base):
        return [t.placements[i] if i in ctx else b
                for i, b in enumerate(base)]
    w_grad = [_partial(mesh, i) if i == hd and _is_shard(heads[i]) else b
              for i, b in enumerate(batch)]
    mask_in = None
    if isinstance(mask, DTensor):
        mask_in = own(mask, [b if mask.shape[0] == split[0].shape[0]
                             else Replicate() for b in batch])
    ins = (tuple(own(t, heads) for t in split)
           + (own(whole, batch), mask_in) + (None,) * len(args))
    if ctx:
        parts = [Partial("max") if i in ctx else h
                 for i, h in enumerate(heads)]
        sums = [Partial() if i in ctx else h for i, h in enumerate(heads)]
        mx, l, acc = _local_map(partial, (parts, sums, sums), ins, None,
                                mesh)(*split, whole, mask, *args)
        return combine_parts(mx, l, acc, _heads_last, heads)
    grads = (heads,) * len(split) + (w_grad, mask_in) + (None,) * len(args)
    run = _local_map(fn, heads, ins, grads, mesh)
    return run(*(_grad_to(t) for t in split), _grad_to(whole), mask, *args)


def _heads_last(out):
    """(B, H, S, D) -> (B, S, H, D)."""
    return out.permute(0, 2, 1, 3)


def split_slots(q: DTensor, *pairs):
    """Each (t, dim) of ``pairs`` (a cache (B, T, ...) and its slots' dim,
    a mask and its last dim) split on ``dim`` over the mesh dims other
    than "model" that leave the batch whole (q's rows replicated there:
    long_500k's one row), where they divide the slots: each such rank then
    attends its part of them, as the JAX package's partitioner spreads
    that attention over the idle data axes. Each rank keeps its part;
    nothing moves."""
    mesh = q.device_mesh
    hd = _model_dim(mesh)
    ts = [(_as_dtensor(t, mesh), dim % t.ndim) for t, dim in pairs]
    target, n = [list(t.placements) for t, _ in ts], 1
    for i in range(mesh.ndim):
        if (i != hd and mesh.size(i) > 1
                and isinstance(q.placements[i], Replicate)
                and all(isinstance(t.placements[i], Replicate)
                        and t.shape[d] % (n * mesh.size(i)) == 0
                        for t, d in ts)):
            for tgt, (_, d) in zip(target, ts):
                tgt[i] = Shard(d)
            n *= mesh.size(i)
    return [t if tuple(tgt) == tuple(t.placements)
            else t.redistribute(mesh, tgt)
            for (t, _), tgt in zip(ts, target)]


def combine_parts(mx: DTensor, l: DTensor, acc: DTensor, finish,
                  out) -> DTensor:
    """The softmax attention over parts of the slots, from each part's
    (max m, sum l, product acc), partial over the mesh dims that split the
    slots: one all-reduce of the max and two of the sums rescaled to it,
    then ``finish(acc / l)`` placed as ``out``."""
    mesh = mx.device_mesh
    top = _reduced(mx)
    plain = list(_grad_placements(mx.placements))

    def rescale(mx_, top_, l_, acc_):
        s = torch.exp(mx_ - top_)
        return l_ * s, acc_ * s[..., None]

    l, acc = _local_map(rescale, (l.placements, acc.placements),
                        (mx.placements, plain, l.placements,
                         acc.placements), None, mesh)(mx, top, l, acc)
    l, acc = _reduced(l), _reduced(acc)
    return _local_map(lambda l_, acc_: finish(acc_ / l_[..., None]), out,
                      (plain, plain), None, mesh)(l, acc)


def context_attention(partial, q, k, v, mask, ctx: List[int]) -> DTensor:
    """Attention over k, v whose slots (dim 1) are split over mesh dims
    ``ctx``: q whole over them, each rank's ``partial(q, k, v, mask)`` over
    its slots, (max m, sum l, product acc) of its scores, m and l
    (B, Hkv, G, S) and acc (B, Hkv, G, S, D) fp32, joined by
    ``combine_parts``. No gradient (a decode step)."""
    mesh = q.device_mesh
    batch = [Shard(0) if _is_shard(p, 0) else Replicate()
             for p in q.placements]
    kv_in = [Shard(1) if i in ctx else b for i, b in enumerate(batch)]
    mask = _as_dtensor(mask, mesh)
    mask_in = [Shard(mask.ndim - 1) if i in ctx else
               (b if mask.shape[0] == q.shape[0] else Replicate())
               for i, b in enumerate(batch)]
    sums = [Partial() if i in ctx else b for i, b in enumerate(batch)]
    parts = [Partial("max") if i in ctx else b for i, b in enumerate(batch)]
    mx, l, acc = _local_map(partial, (parts, sums, sums),
                            (batch, kv_in, kv_in, mask_in), None, mesh)(
        q, k, v, mask)
    def finish(out):
        out = out.permute(0, 3, 1, 2, 4)        # (B, S, Hkv, G, D)
        return out.reshape(out.shape[:2] + (-1, out.shape[-1])).to(q.dtype)
    return combine_parts(mx, l, acc, finish, batch)


# ---------------------------------------------------------------------------
# the other blocks' shard-local parts
# ---------------------------------------------------------------------------

def local_conv(fn, x: DTensor, w: torch.Tensor,
               tail: Optional[torch.Tensor]):
    """``fn(x, w, tail)``, a depthwise causal conv (x (B, S, C), w (k, C),
    tail (B, k-1, C) or None) -> (out, new tail), on each rank's rows and
    channels: the channels split as ``w``'s are."""
    mesh = _mesh_of(x, w)
    x, w = _as_dtensor(x, mesh), _as_dtensor(w, mesh)
    rows = _rows(x, x.ndim - 1)
    lanes = [Shard(2) if _is_shard(p, 1) else r
             for p, r in zip(w.placements, rows)]
    w_grad = [p if _is_shard(p) else
              (_partial(mesh, i) if _is_shard(rows[i]) else Replicate())
              for i, p in enumerate(w.placements)]
    ins = [lanes, tuple(w.placements), lanes if tail is not None else None]
    grads = [lanes, w_grad, ins[2]]
    args = [_grad_to(x), _grad_to(w), tail]
    if tail is not None:
        args[2] = _grad_to(_as_dtensor(tail, mesh))
    return _local_map(fn, (lanes, lanes), tuple(ins), tuple(grads),
                      mesh)(*args)


def last_dim_split(x: DTensor) -> bool:
    """Whether ``x``'s last dim is split over a mesh dim of size > 1."""
    mesh = x.device_mesh
    return any(mesh.size(i) > 1
               for i in _shard_dims(x.placements, x.ndim - 1))


def rms_norm(x: DTensor, weight: torch.Tensor, eps: float) -> DTensor:
    """The RMSNorm (``kernels.ref.rmsnorm``) over the last dim of ``x``,
    which is split: the shards' sums of squares all-reduced (B, S, 1), and
    each shard normalised by it and its part of ``weight``."""
    mesh = _mesh_of(x, weight)
    x, weight = _as_dtensor(x, mesh), _as_dtensor(weight, mesh)
    last = x.ndim - 1
    rows = _rows(x, last)
    split = [i for i, p in enumerate(x.placements)
             if _is_shard(p, last) and mesh.size(i) > 1]
    lanes = [Shard(last) if i in split else r for i, r in enumerate(rows)]
    w_in = [Shard(0) if i in split else Replicate()
            for i in range(mesh.ndim)]
    w_grad = [Shard(0) if i in split else
              (_partial(mesh, i) if _is_shard(r) else Replicate())
              for i, r in enumerate(rows)]
    n = x.shape[last]
    ss = _local_map(
        lambda a: torch.sum(torch.square(a.float()), dim=-1, keepdim=True),
        [Partial() if i in split else r for i, r in enumerate(rows)],
        (lanes,), (lanes,), mesh)(x)
    ss = _reduced(ss)

    def norm(a, s, w_):
        return (a.float() * torch.rsqrt(s / n + eps)
                * w_.float()).to(a.dtype)
    # each shard's part of the sum's gradient: partial sums over the split
    s_grad = [_partial(mesh, i) if i in split else r
              for i, r in enumerate(rows)]
    return _local_map(norm, lanes, (lanes, rows, w_in),
                      (lanes, s_grad, w_grad), mesh)(x, ss, _grad_to(weight))


def fuses_shared(w_gate: DTensor, shared: dict) -> bool:
    """Whether the shared experts' weights (``w_gate``, ``w_in`` (d, F),
    ``w_out`` (F, d)) split F over the mesh dims of size > 1 that split the
    experts (``w_gate`` (E, d, F)), and over no other: then each rank's part
    of the shared experts' product is a partial sum over the same dims as
    its experts' (``moe_experts`` adds the two before one reduce)."""
    mesh = w_gate.device_mesh

    def split(w, dim):
        if not isinstance(w, DTensor):
            return None
        if any(mesh.size(i) > 1 and _is_shard(p) and p.dim != dim
               for i, p in enumerate(w.placements)):
            return None
        return {i for i in _shard_dims(w.placements, dim) if mesh.size(i) > 1}

    experts = split(w_gate, 0)
    return bool(experts) and all(
        split(shared[name], dim) == experts
        for name, dim in (("w_gate", 1), ("w_in", 1), ("w_out", 0)))


def moe_experts(fn, x: DTensor, combine: DTensor, w_gate, w_in, w_out,
                *shared):
    """``fn(x, combine, w_gate, w_in, w_out, *shared)`` (the dense
    dispatch's expert products: x (B, S, d), combine (B, S, E), expert
    weights (E, ...); with ``shared``, the shared experts' (w_gate, w_in,
    w_out), which ``fuses_shared`` holds, their product added) -> (B, S, d)
    fp32, on each rank's rows and experts (expert-parallel over the mesh
    dims that split the experts) and its columns of the shared experts'
    hidden layer, the partial sums all-reduced once, in fp32: the one
    reduce the JAX package's partitioned program makes of an MoE layer's
    output. x's gradient, a partial sum of the experts' and the shared
    experts' parts, is all-reduced once too."""
    mesh = _mesh_of(x, w_gate)
    x, combine = _as_dtensor(x, mesh), _as_dtensor(combine, mesh)
    ws = [_as_dtensor(w, mesh) for w in (w_gate, w_in, w_out) + shared]
    rows = _rows(x, x.ndim - 1)
    experts = [i for i, p in enumerate(ws[0].placements) if _is_shard(p, 0)]
    c_in = [Shard(2) if i in experts else r for i, r in enumerate(rows)]
    x_grad = [_partial(mesh, i) if i in experts else r
              for i, r in enumerate(rows)]

    def split(dim):
        """A weight split on ``dim`` over the experts' mesh dims: its
        placements, and its gradient's (partial over the batch's)."""
        into = [Shard(dim) if i in experts else Replicate()
                for i in range(mesh.ndim)]
        grad = [Shard(dim) if i in experts else
                (_partial(mesh, i) if _is_shard(r) else Replicate())
                for i, r in enumerate(rows)]
        return into, grad
    w_in_pl, w_grad = split(0)
    ins, grads = [w_in_pl] * 3, [w_grad] * 3
    if shared:
        (col, col_grad), (row, row_grad) = split(1), split(0)
        ins += [col, col, row]
        grads += [col_grad, col_grad, row_grad]
    out = [_partial(mesh, i) if i in experts else r
           for i, r in enumerate(rows)]
    run = _local_map(fn, out, (rows, c_in) + tuple(ins),
                     (x_grad, c_in) + tuple(grads), mesh)
    return _reduced(run(_grad_to(x), _grad_to(combine),
                        *(_grad_to(w) for w in ws)))


def route(fn, x: DTensor, router, top_k: int):
    """``fn(x, router, top_k)``, an MoE router (x (B, S, d) and its weight
    (d, E) -> the probabilities, top-k weights and experts, each
    (B, S, .)), on each rank's rows: every rank of "model" routes its rows
    whole, as each needs all of their experts' weights, and the softmax,
    the sort and their gradients stay local. x's gradient is then whole on
    each of those ranks; the router's is a partial sum over the mesh dims
    that split the batch."""
    mesh = _mesh_of(x, router)
    x, router = _as_dtensor(x, mesh), _as_dtensor(router, mesh)
    rows = _rows(x, x.ndim - 1)
    whole = [Replicate()] * mesh.ndim
    w_grad = [_partial(mesh, i) if _is_shard(r) else Replicate()
              for i, r in enumerate(rows)]
    run = _local_map(fn, (rows, rows, rows), (rows, whole, None),
                     (rows, w_grad, None), mesh)
    return run(_grad_to(x), _grad_to(router), top_k)


def batch_mean(t: DTensor, dims: Tuple[int, ...]):
    """``t.mean(dims)`` of a DTensor whose split over the batch's mesh dims
    (of size > 1) is a split of ``dims[0]``, the rest of ``dims`` whole:
    each rank's mean of its rows over the ranks' count, summed by one
    all-reduce. Where no such mesh dim splits ``t``, DTensor's own mean,
    which moves nothing."""
    mesh = t.device_mesh
    split = [i for i in _shard_dims(t.placements, dims[0])
             if mesh.size(i) > 1]
    if not split:
        return t.mean(dim=dims)
    assert all(isinstance(p, Replicate) or _is_shard(p, dims[0])
               for p in t.placements), t.placements
    n = 1
    for i in split:
        n *= mesh.size(i)
    rows = list(t.placements)
    out = [Partial() if i in split else Replicate()
           for i in range(mesh.ndim)]
    mean = _local_map(lambda a: a.mean(dim=dims) / n, out, (rows,), (rows,),
                      mesh)(t)
    return _reduced(mean)


def global_norm(tree) -> torch.Tensor:
    """The l2 norm over every DTensor of ``tree`` (gradients, each placed
    as its param: split or whole, no partial sum), as one replicated
    DTensor: each leaf's local sum of squares, those split over the same
    mesh dims summed in leaf order and all-reduced over those dims, and
    the groups' sums added. With nothing split over more than one rank,
    the sums in leaf order of ``optimizer.global_norm``, and no
    collective."""
    from repro_torch.models.common import tree_tensors

    leaves = list(tree_tensors(tree))
    mesh = leaves[0].device_mesh
    groups = {}
    for g in leaves:
        dims = tuple(i for i, p in enumerate(g.placements)
                     if _is_shard(p) and mesh.size(i) > 1)
        sq = torch.sum(torch.square(g.to_local().float()))
        groups[dims] = groups[dims] + sq if dims in groups else 0 + sq
    total = 0
    for dims, sq in groups.items():
        for i in dims:
            sq = funcol.all_reduce(sq, "sum", (mesh, i))
        total = total + sq
    return DTensor.from_local(torch.sqrt(total), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def placed_as(ts, likes) -> list:
    """Each DTensor of ``ts`` brought to the placements of its counterpart
    in ``likes`` (trees of one structure: gradients and their params, or a
    state and the cache it is written into): over a mesh dim of more than
    one rank by a redistribute (a partial sum that DTensor's own rules
    left, a norm's weight's summed over the batch's rows, is all-reduced;
    rows split where the cache holds them whole are gathered), over one of
    one rank relabelled (nothing to move)."""
    from repro_torch.models.common import tree_tensors

    out = []
    for t, like in zip(tree_tensors(ts), tree_tensors(likes)):
        if isinstance(t, DTensor) and tuple(t.placements) != tuple(
                like.placements):
            mesh = t.device_mesh
            moved = [q if mesh.size(i) > 1 else tp for i, (q, tp) in
                     enumerate(zip(like.placements, t.placements))]
            t = t.redistribute(mesh, moved)
            if tuple(moved) != tuple(like.placements):
                t = DTensor.from_local(t.to_local(), mesh, like.placements,
                                       run_check=False, shape=t.shape,
                                       stride=t.stride())
        out.append(t)
    return out


class _Across(torch.autograd.Function):
    """One collective over mesh dim ``i`` of local tensors, with its
    adjoint: "scatter", a reduce-scatter of dim 1 (backward: the
    all-gather); "gather", an all-gather of dim 1 (backward: the
    reduce-scatter); "sum", an all-reduce of parts that no two ranks both
    hold, whose sum every rank then reads for its own rows only (backward:
    the identity, each rank's gradient already whole where it reads)."""

    @staticmethod
    def forward(ctx, t, kind, mesh, i):
        ctx.meta = (kind, mesh, i)
        return _across(t, kind, (mesh, i))

    @staticmethod
    def backward(ctx, grad):
        kind, mesh, i = ctx.meta
        if kind != "sum":
            back = "gather" if kind == "scatter" else "scatter"
            grad = _across(grad.contiguous(), back, (mesh, i))
        return grad, None, None, None


def _across(t: torch.Tensor, kind: str, group) -> torch.Tensor:
    if kind == "scatter":
        return funcol.reduce_scatter_tensor(t, "sum", scatter_dim=1,
                                            group=group)
    if kind == "gather":
        return funcol.all_gather_tensor(t, gather_dim=1, group=group)
    return funcol.all_reduce(t, "sum", group)


class _RankBuffer:
    """A rank's share of the capacity dispatch's (E, C, D) buffer, in the
    form ``blocks.capacity_experts`` reads (``blocks.WholeBuffer``'s): the
    experts the mesh dims ``experts`` give it, and every assignment's rank
    within its expert counted over the whole batch, whose rows the mesh
    dims ``rows`` split (data-major): its local arrival rank plus the
    assignments to that expert on the ranks before it (one all-gather of
    the (E,) counts). With ``split_rows`` the buffer's C rows are split
    over ``rows`` too (padded to a multiple of their ranks): each rank
    fills its tokens' rows and one reduce-scatter gives each rank its
    part; the outputs are all-gathered back. Without, one all-reduce gives
    each rank its experts' whole buffer. The contributions of a token's
    assignments, each made on the rank of its expert, are joined by one
    all-reduce over ``experts``, and each rank sums its tokens' K
    contributions in the plain path's order."""

    def __init__(self, mesh, rows, experts, num_experts: int, capacity: int,
                 split_rows: bool):
        self.mesh, self.rows_dims, self.expert_dims = mesh, rows, experts
        self.num_experts, self.capacity = num_experts, capacity
        self.first, self.experts = _offset(mesh, experts, num_experts)
        n = 1
        for d in rows:
            n *= mesh.size(d)
        self.split = split_rows and n > 1
        self.rows = -(-capacity // n) * n if self.split else capacity

    def slots(self, e_flat: torch.Tensor):
        from repro_torch.models.blocks import arrival_ranks
        E = self.num_experts
        rank = arrival_ranks(e_flat, E)
        if self.rows_dims:
            counts = torch.zeros(E, dtype=rank.dtype, device=rank.device)
            counts.index_add_(0, e_flat, torch.ones_like(e_flat))
            seen = counts[None]
            for d in reversed(self.rows_dims):
                seen = funcol.all_gather_tensor(seen, gather_dim=0,
                                                group=(self.mesh, d))
            me, _ = _offset(self.mesh, self.rows_dims, seen.shape[0])
            rank = rank + seen[:me].sum(dim=0)[e_flat]
        keep = rank < self.capacity
        own = keep & (e_flat >= self.first) & (
            e_flat < self.first + self.experts)
        slot = torch.where(own, (e_flat - self.first) * self.rows + rank,
                           self.experts * self.rows)
        return slot, keep, own

    def dispatch(self, xe: torch.Tensor) -> torch.Tensor:
        for d in self.rows_dims:
            xe = _Across.apply(xe, "scatter" if self.split else "sum",
                               self.mesh, d)
        return xe

    def collect(self, ye: torch.Tensor) -> torch.Tensor:
        if self.split:
            for d in reversed(self.rows_dims):
                ye = _Across.apply(ye, "gather", self.mesh, d)
        return ye

    def combine(self, contrib: torch.Tensor) -> torch.Tensor:
        for d in self.expert_dims:
            contrib = _Across.apply(contrib, "sum", self.mesh, d)
        return contrib


def moe_capacity(x: DTensor, top_w, top_idx, w_gate, w_in, w_out, *,
                 capacity: int, split_rows: bool):
    """``blocks.capacity_experts`` (the capacity dispatch's experts: x
    (B, S, d), the routing's top-k weights and experts (B, S, K), expert
    weights (E, ...), C = ``capacity`` rows an expert) on each rank's rows
    and experts (expert-parallel over the mesh dims that split the
    experts), with the routing, the kept set and each token's sum of its
    contributions those of the whole batch unplaced (``_RankBuffer``).
    ``split_rows`` (``moe_ep_constraint``) splits the buffer's rows over
    the mesh dims that split the batch, as the JAX package's constraint
    P("model", "data", None) places it; without it, each of those ranks
    runs its experts on the whole buffer, as the JAX package's partitioner
    leaves it. (y (B, S, d) fp32, keep (B, S, K)), split over the batch
    as x is."""
    from repro_torch.models.blocks import capacity_experts
    mesh = _mesh_of(x, w_gate)
    x, top_w, top_idx = (_as_dtensor(t, mesh) for t in (x, top_w, top_idx))
    ws = [_as_dtensor(w, mesh) for w in (w_gate, w_in, w_out)]
    rows = _rows(x, x.ndim - 1)
    row_dims = [i for i, p in enumerate(rows)
                if _is_shard(p) and mesh.size(i) > 1]
    experts = [i for i, p in enumerate(ws[0].placements)
               if _is_shard(p, 0) and mesh.size(i) > 1]
    if set(row_dims) & set(experts):
        raise ValueError("a mesh dim splits both the batch and the experts")
    buffer = _RankBuffer(mesh, row_dims, experts, w_gate.shape[0], capacity,
                         split_rows)
    a_grad = [_partial(mesh, i) if i in experts else r
              for i, r in enumerate(rows)]
    w_in_pl = [Shard(0) if i in experts else Replicate()
               for i in range(mesh.ndim)]
    w_grad = [Shard(0) if i in experts else
              (Partial() if i in row_dims else Replicate())
              for i in range(mesh.ndim)]

    def run(x_, w_, idx_, wg, wi, wo):
        return capacity_experts(x_, w_, idx_, wg, wi, wo, buffer)

    return _local_map(run, (rows, rows),
                      (rows, rows, rows, w_in_pl, w_in_pl, w_in_pl),
                      (a_grad, a_grad, rows, w_grad, w_grad, w_grad), mesh)(
        _grad_to(x), _grad_to(top_w), top_idx, *(_grad_to(w) for w in ws))


def ssd_heads(fn, n_heads: int, z, x, b, c, dt, dt_bias, a_log, d_skip,
              ssm=None):
    """``fn(z, x, b, c, dt, dt_bias, a_log, d_skip, ssm)`` -> (y, final
    state): the SSD of the heads that z (B, S, h * P), x (B, S, h * P) and
    dt (B, S, h) hold, and of the small per-head vectors given for them
    (y (B, S, h * P), the state (B, h, P, N)), run on each rank's rows and
    its heads over "model" (all of them where the model axis does not
    divide ``n_heads``). b and c, every head's input and output
    projections, come whole; their gradient leaves as each rank's partial
    sum, for ``ssd_parts`` to add up. ``ssm``, a decode step's state, is
    split over its heads as ``cache_pspecs`` places it."""
    mesh = _mesh_of(z, x)
    z, x, b, c, dt = (_as_dtensor(t, mesh) for t in (z, x, b, c, dt))
    small = [_as_dtensor(t, mesh) for t in (dt_bias, a_log, d_skip)]
    rows = _rows(z, z.ndim - 1)
    hd = _model_dim(mesh)
    if hd is not None and (n_heads % mesh.size(hd)
                           or _is_shard(z.placements[hd], 0)):
        hd = None
    lo, hi = 0, n_heads
    if hd is not None:
        lo, n = _offset(mesh, [hd], n_heads)
        hi = lo + n
    lanes = [Shard(z.ndim - 1) if i == hd else r for i, r in enumerate(rows)]
    state = [Shard(1) if i == hd else r for i, r in enumerate(rows)]
    whole = [Replicate()] * mesh.ndim
    bc_grad = [_partial(mesh, i) if i == hd else r
               for i, r in enumerate(rows)]
    p_grad = [(_partial(mesh, i) if _is_shard(r) or i == hd
               else Replicate()) for i, r in enumerate(rows)]

    def run(z_, x_, b_, c_, dt_, bias_, a_, d_, ssm_):
        return fn(z_, x_, b_, c_, dt_, bias_[lo:hi], a_[lo:hi], d_[lo:hi],
                  ssm_)

    ins = (lanes, lanes, rows, rows, lanes, whole, whole, whole,
           state if ssm is not None else None)
    grads = (lanes, lanes, bc_grad, bc_grad, lanes, p_grad, p_grad, p_grad,
             ins[-1])
    ssm = _as_dtensor(ssm, mesh) if ssm is not None else None
    # z, x, b, c and dt leave their gradients to the exchange that made
    # them (``ssd_parts``)
    return _local_map(run, (lanes, state), ins, grads, mesh)(
        z, x, b, c, dt, *(_grad_to(t) for t in small), ssm)


def _exchange_plan(sizes: Tuple[int, ...], split: Tuple[int, ...], m: int,
                   c: int):
    """Rank ``c``'s part of ``_Exchange``: the columns of its shard to send,
    one block a rank in rank order (local indices), each block's length,
    and the lengths it receives from each rank. Rank r is sent the columns
    of ``t`` that it takes: each part of ``split`` its r-th of m even
    slices, each other part whole."""
    w = sum(sizes) // m

    def takes(r):
        cols, o = [], 0
        for i, n in enumerate(sizes):
            lo, hi = ((o + r * (n // m), o + (r + 1) * (n // m))
                      if i in split else (o, o + n))
            cols.append((lo, hi))
            o += n
        return cols

    def inside(spans, s):
        return [(max(lo, s * w), min(hi, (s + 1) * w)) for lo, hi in spans
                if max(lo, s * w) < min(hi, (s + 1) * w)]

    send = [[j - c * w for lo, hi in inside(takes(r), c)
             for j in range(lo, hi)] for r in range(m)]
    recv = [sum(hi - lo for lo, hi in inside(takes(c), s)) for s in range(m)]
    return send, recv


class _Exchange(torch.autograd.Function):
    """``ssd_parts``' move: one all-to-all over "model" sends each rank the
    columns of ``t`` (split evenly on its last dim there) that it takes,
    and the backward pass sends each column's gradients back to the rank
    that holds it, added up there one sender after another (B and C, which
    every rank takes, gather a partial sum from each)."""

    @staticmethod
    def forward(ctx, t, hd, sizes, split):
        mesh, last = t.device_mesh, t.ndim - 1
        m, c = mesh.size(hd), mesh.get_coordinate()[hd]
        send, recv = _exchange_plan(sizes, split, m, c)
        local = t.to_local()
        idx = torch.tensor([j for block in send for j in block],
                           dtype=torch.long, device=local.device)
        ctx.meta = (t, hd, sizes, split, send, recv)
        cols = local.movedim(last, 0).index_select(0, idx)
        got = funcol.all_to_all_single(cols, recv, [len(b) for b in send],
                                       group=(mesh, hd))
        got = got.movedim(0, last)
        outs, o = [], 0
        for i, n in enumerate(sizes):
            k = n // m if i in split else n
            placements = list(t.placements)
            placements[hd] = Shard(last) if i in split else Replicate()
            shape = t.shape[:last] + (n,)
            outs.append(DTensor.from_local(
                got.narrow(last, o, k).contiguous(), mesh, placements,
                run_check=False, shape=torch.Size(shape),
                stride=_contiguous_strides(shape)))
            o += k
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        t, hd, sizes, split, send, recv = ctx.meta
        mesh, last = t.device_mesh, t.ndim - 1
        m, c = mesh.size(hd), mesh.get_coordinate()[hd]
        local = t.to_local()
        parts = []
        for i, (g, n) in enumerate(zip(grads, sizes)):
            k = n // m if i in split else n
            if g is None:
                parts.append(local.new_zeros(local.shape[:last] + (k,)))
                continue
            target = list(t.placements)
            target[hd] = (Shard(last) if i in split else
                          g.placements[hd] if isinstance(g.placements[hd],
                                                         Partial)
                          else Replicate())
            g_local = g.redistribute(mesh, target).to_local()
            if isinstance(target[hd], Replicate) and c:
                # a whole gradient, the same on every rank: sent once
                g_local = torch.zeros_like(g_local)
            parts.append(g_local)
        cols = torch.cat(parts, last).movedim(last, 0).contiguous()
        back = funcol.all_to_all_single(cols, [len(b) for b in send], recv,
                                        group=(mesh, hd))
        grad, o = torch.zeros_like(local), 0
        for block in send:
            if block:
                grad.index_add_(last, torch.tensor(block, device=grad.device),
                                back[o:o + len(block)].movedim(0, last))
            o += len(block)
        return (DTensor.from_local(grad, mesh, t.placements, run_check=False,
                                   shape=t.shape, stride=t.stride()),
                None, None, None)


def ssd_parts(t: DTensor, sizes: Sequence[int], split: Sequence[int],
              n_heads: int):
    """``torch.split(t, sizes, -1)`` of a Mamba-2 block's fused columns
    ([z, xBC, dt] of the in-projection, [x, B, C] of the conv's output),
    each part of ``split`` split evenly over "model" where the model axis
    divides it and ``n_heads`` (z, x and dt by heads; xBC on the conv's
    channel split, as ``conv_w``), each other part whole there (B and C, which every head
    reads), where ``t`` is split over "model" on its last dim (a
    column-parallel product, or the conv's channels): one all-to-all
    (``_Exchange``) moves to each rank the columns it takes and no other.
    Otherwise, the plain split on each rank's shard."""
    mesh = t.device_mesh
    hd = _model_dim(mesh)
    if hd is None or not _is_shard(t.placements[hd], t.ndim - 1):
        return torch.split(t, list(sizes), dim=-1)
    m = mesh.size(hd)
    split = tuple(i for i in split if n_heads % m == 0 and sizes[i] % m == 0)
    return _Exchange.apply(t, hd, tuple(sizes), split)


def gather_model(t: DTensor) -> DTensor:
    """``t`` whole over "model" (an all-gather of a split there)."""
    mesh = t.device_mesh
    hd = _model_dim(mesh)
    if hd is None or not _is_shard(t.placements[hd]):
        return t
    target = list(t.placements)
    target[hd] = Replicate()
    return t.redistribute(mesh, target)


def _neighbours(mesh, hd: int, r: int):
    """The process group of this rank and the r - 1 others of its run of r
    on mesh dim ``hd`` (coordinates r g .. r g + r - 1 there, the other
    coordinates this rank's). Every rank makes every such group once a
    mesh (a collective), and the mesh keeps them."""
    import torch.distributed as dist

    groups = mesh.__dict__.setdefault("_runs_of", {})
    if (hd, r) not in groups:
        lines = mesh.mesh.movedim(hd, -1).reshape(-1, mesh.size(hd))
        runs = [line[g:g + r].tolist() for line in lines
                for g in range(0, mesh.size(hd), r)]
        groups[(hd, r)] = dist.new_subgroups_by_enumeration(runs)[0]
    return groups[(hd, r)]


class _GatherKV(torch.autograd.Function):
    """``kv_heads``' gather: each rank's columns of the kv head its query
    heads read, all-gathered among the r ranks that hold that head's
    parts; the gradient reduce-scattered back among them."""

    @staticmethod
    def forward(ctx, t, hd, r, head_dim):
        mesh, last = t.device_mesh, t.ndim - 1
        group = _neighbours(mesh, hd, r)
        ctx.meta = (t, hd, group)
        head = funcol.all_gather_tensor(t.to_local(), gather_dim=last,
                                        group=group)
        placements = list(t.placements)
        placements[hd] = Shard(2)
        shape = t.shape[:last] + (mesh.size(hd), head_dim)
        return DTensor.from_local(head.unsqueeze(2), mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous_strides(shape))

    @staticmethod
    def backward(ctx, grad):
        t, hd, group = ctx.meta
        target = list(t.placements)
        target[hd] = Shard(2)
        g = grad.redistribute(grad.device_mesh, target).to_local()
        part = funcol.reduce_scatter_tensor(g.squeeze(2).contiguous(), "sum",
                                            scatter_dim=t.ndim - 1,
                                            group=group)
        return (DTensor.from_local(part, t.device_mesh, t.placements,
                                   run_check=False, shape=t.shape,
                                   stride=t.stride()), None, None, None)


def kv_heads(t: DTensor, count: int, head_dim: int, n_query: int) -> DTensor:
    """k or v (B, S, count * head_dim), a column-parallel product, viewed
    as its ``count`` kv heads for an attention over ``n_query`` query
    heads: ``split_dim``'s view, but where "model" (m) divides the query
    heads and is a multiple r of 1 < ``count`` kv heads (so that the H / m
    query heads of a rank read one kv head, whose columns its r
    neighbours hold), each rank all-gathers that head among those r ranks
    alone, as the JAX package's partitioner does, and not every head over
    "model". The result is then the kv heads each repeated r times
    (B, S, m, head_dim), one a rank over "model"; an attention over it
    reads what it would of the ``count`` heads, and ``kv_cache_layout``
    takes the repeats back out."""
    mesh = t.device_mesh
    hd = _model_dim(mesh)
    if hd is not None and _is_shard(t.placements[hd], t.ndim - 1):
        m = mesh.size(hd)
        if 1 < count < m and m % count == 0 and n_query % m == 0:
            return _GatherKV.apply(t, hd, m // count, head_dim)
    return split_dim(t, 2, (count, head_dim))


class _KVSlots(torch.autograd.Function):
    """``kv_cache_layout``'s move of repeated kv heads (B, T, m, D), one a
    rank over "model", to the cache's (B, T, count, D) with its slots split
    there: one all-to-all in which each rank sends each slot block of its
    head to the rank that holds the block, where its run's ranks share the
    sending (rank c sends to the ranks whose coordinate is c modulo r), so
    every block moves once. The gradient goes back the same way."""

    @staticmethod
    def forward(ctx, t, hd, count):
        mesh = t.device_mesh
        m, c = mesh.size(hd), mesh.get_coordinate()[hd]
        r = m // count
        dests = [d for d in range(m) if d % r == c % r]
        ins = [int(d % r == c % r) for d in range(m)]
        ctx.meta = (t, hd, dests, ins)
        local = t.to_local()[:, :, 0]                    # (B, T, D)
        blocks = local.unflatten(1, (m, -1)).movedim(1, 0)[dests]
        got = funcol.all_to_all_single(blocks, ins, ins, group=(mesh, hd))
        placements = list(t.placements)
        placements[hd] = Shard(1)
        shape = t.shape[:2] + (count, t.shape[3])
        return DTensor.from_local(got.permute(1, 2, 0, 3).contiguous(), mesh,
                                  placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_strides(shape))

    @staticmethod
    def backward(ctx, grad):
        t, hd, dests, ins = ctx.meta
        mesh = t.device_mesh
        target = list(t.placements)
        target[hd] = Shard(1)
        g = grad.redistribute(mesh, target).to_local()   # (B, T/m, count, D)
        back = funcol.all_to_all_single(g.permute(2, 0, 1, 3).contiguous(),
                                        ins, ins, group=(mesh, hd))
        local = t.to_local()
        out = local.new_zeros(local.shape[:2] + local.shape[3:])
        out.unflatten(1, (mesh.size(hd), -1))[:, dests] = back.movedim(0, 1)
        return (DTensor.from_local(out.unsqueeze(2), mesh, t.placements,
                                   run_check=False, shape=t.shape,
                                   stride=t.stride()), None, None)


def kv_cache_layout(t: DTensor, count: int) -> DTensor:
    """A prefill's k or v cache (B, T, heads, D) of ``count`` kv heads,
    placed over "model" as ``cache_layout`` places it. Where ``t`` holds
    them repeated (``kv_heads``: m heads, one a rank), the repeats are
    taken out: the slots split over "model" where it divides them
    (``_KVSlots``), else each head whole on every rank."""
    if t.shape[2] == count:
        return cache_layout(t, 2)
    mesh = t.device_mesh
    hd = _model_dim(mesh)
    m = mesh.size(hd)
    if t.shape[1] % m == 0:
        return _KVSlots.apply(t, hd, count)
    return gather_model(t)[:, :, ::m // count]


def cache_layout(t: DTensor, dim: int) -> DTensor:
    """A prefill's cache tensor, (B, T, ...), placed over "model" as
    ``cache_pspecs`` places a decode cache: kept where ``dim`` (its heads,
    rank or lanes) is split there already; else, where it is whole, split
    on ``dim`` where "model" divides it (or, for a KV cache's heads, on
    its slots where it divides them: the context-parallel fallback). Each
    rank keeps its part; nothing moves."""
    mesh = t.device_mesh
    hd = _model_dim(mesh)
    if hd is None or not isinstance(t.placements[hd], Replicate):
        return t
    m = mesh.size(hd)
    target = list(t.placements)
    if t.shape[dim] % m == 0:
        target[hd] = Shard(dim)
    elif t.ndim == 4 and dim == 2 and t.shape[1] % m == 0:
        target[hd] = Shard(1)
    else:
        return t
    return t.redistribute(mesh, target)


# ---------------------------------------------------------------------------
# embedding, stacking, the loss, the cache write, the RG-LRU scan
# ---------------------------------------------------------------------------

def vocab_split(logits: torch.Tensor) -> bool:
    """Whether ``logits`` is a DTensor whose last (vocab) dim is split over
    more than one rank."""
    if not isinstance(logits, DTensor):
        return False
    mesh = logits.device_mesh
    return any(mesh.size(d) > 1
               for d in _shard_dims(logits.placements, logits.ndim - 1))


def embedding(table: DTensor, tokens: torch.Tensor) -> DTensor:
    """``table[tokens]`` of a placed table (V, d), Megatron's
    vocab-parallel lookup: each rank looks up the tokens that fall in its
    shard of the vocab (zeros for the rest), and one all-reduce over the
    vocab's mesh dims sums them; the result is split over the batch as the
    tokens are. The backward pass (an accumulating scatter into the
    table's shard) is local too, where DTensor's rule for it fails in some
    releases."""
    mesh = table.device_mesh
    vocab_dims = [i for i in _shard_dims(table.placements, 0)
                  if mesh.size(i) > 1]
    tokens = _as_dtensor(tokens, mesh)
    rows = [p if isinstance(p, Shard) and p.dim == 0 and i not in vocab_dims
            else Replicate() for i, p in enumerate(tokens.placements)]
    table_placements = [Shard(0) if i in vocab_dims else Replicate()
                        for i in range(mesh.ndim)]
    out = [Partial() if i in vocab_dims else
           (Shard(0) if isinstance(rows[i], Shard) else Replicate())
           for i in range(mesh.ndim)]
    start, length = _offset(mesh, vocab_dims, table.shape[0])

    def lookup(t, ids):
        if not vocab_dims:
            return t[ids]
        local = ids.long() - start
        inside = (local >= 0) & (local < length)
        rows_ = t[torch.where(inside, local, 0)]
        return torch.where(inside[..., None], rows_, 0.0)

    # each rank scatters its own rows' gradients into the table: partial
    # sums over the mesh dims that split the batch
    table_grads = [Partial() if isinstance(rows[i], Shard)
                   else table_placements[i] for i in range(mesh.ndim)]
    run = _local_map(lookup, out, (table_placements, rows),
                     (table_grads, rows), mesh)
    return _reduced(run(_grad_to(table), tokens))


def stack_layers(tensors: List[DTensor]) -> DTensor:
    """``torch.stack`` of DTensors placed alike (the per-layer caches of a
    prefill): each rank stacks its shards, and the result is split as they
    are, one dim further on. DTensor's rule for stack fails in some
    releases."""
    first = tensors[0]
    mesh, placements = first.device_mesh, first.placements
    local = torch.stack([t.redistribute(mesh, placements).to_local()
                         for t in tensors])
    shape = (len(tensors),) + tuple(first.shape)
    return DTensor.from_local(
        local, mesh, [Shard(p.dim + 1) if isinstance(p, Shard) else p
                      for p in placements],
        run_check=False, shape=shape, stride=_contiguous_strides(shape))


def unstack(t: DTensor) -> List[DTensor]:
    """The layers of a DTensor stacked on dim 0 (never split), each rank's
    shard of each: placed as the stack is, one dim nearer."""
    mesh = t.device_mesh
    placements = [Shard(p.dim - 1) if _is_shard(p) else p
                  for p in t.placements]
    shape, local = tuple(t.shape[1:]), t.to_local()
    return [DTensor.from_local(local[i], mesh, placements, run_check=False,
                               shape=torch.Size(shape),
                               stride=_contiguous_strides(shape))
            for i in range(t.shape[0])]


def _move_split(t: DTensor, i: int, dst: int) -> DTensor:
    """``t``, split over mesh dim ``i`` on tensor dim ``dst`` instead of the
    one it is split on there: one all-to-all of each rank's shard, in
    chunks of ``dst``, its output one buffer of the shard's size (as NCCL
    runs it; DTensor's own move gathers the whole dim on a CPU mesh)."""
    mesh, src = t.device_mesh, t.placements[i].dim
    local = t.to_local()
    chunks = local.unflatten(dst, (mesh.size(i), -1)).movedim(dst, 0)
    got = funcol.all_to_all_single(chunks.contiguous(), None, None,
                                   group=(mesh, i))
    # chunk s is rank s's part of dim ``src``
    local = got.movedim(0, src).flatten(src, src + 1)
    placements = list(t.placements)
    placements[i] = Shard(dst)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def unsplit_layers(t: DTensor, lanes: int) -> DTensor:
    """A stack (L, B, ...) whose layers are split over the data axes (the
    placement ``cache_pspecs`` gives a Mamba-2 state, whose name marks no
    layer axis), placed with every layer on every rank: each mesh dim that
    split the layers splits the rows (dim 1) instead, an all-to-all, and
    "model" splits dim ``lanes`` (the heads, the channels) where it
    divides it and the stack is whole there. Each rank then steps its own
    rows and lanes of each layer; ``write_back`` returns them."""
    mesh = t.device_mesh
    hd = _model_dim(mesh)
    target = list(t.placements)
    if (hd is not None and isinstance(target[hd], Replicate)
            and t.shape[lanes] % mesh.size(hd) == 0):
        target[hd] = Shard(lanes)
        t = t.redistribute(mesh, target)
    for i, p in enumerate(t.placements):
        if _is_shard(p, 0):
            t = _move_split(t, i, 1)
    return t


def write_back(stack: DTensor, work: DTensor) -> None:
    """Copy ``work`` (``unsplit_layers`` of ``stack``, stepped) into
    ``stack``'s own shards, in place: the rows back to layers (an
    all-to-all), then, layer by layer, the lanes gathered (an all-gather)
    where ``stack`` holds them whole."""
    mesh = stack.device_mesh
    for i, p in enumerate(stack.placements):
        if _is_shard(p, 0):
            work = _move_split(work, i, 0)
    gather = [(i, q.dim - 1) for i, (p, q) in
              enumerate(zip(stack.placements, work.placements)) if p != q]
    local, out = work.to_local(), stack.to_local()
    for j in range(local.shape[0]):
        layer = local[j]
        for i, dim in gather:
            layer = funcol.all_gather_tensor(layer, gather_dim=dim,
                                             group=(mesh, i))
        out[j].copy_(layer)


def local_scan(fn, xc, pre_i, pre_r, lam, pre_y, h0):
    """``fn(xc, pre_i, pre_r, lam, pre_y, h0)``, the RG-LRU block's gates
    and recurrence (``kernels.ref.rglru_gated_scan``): (B, S, W) operands,
    the (W,) lambda and the (B, W) state, run on each rank's own rows and
    lanes (the recurrence is elementwise in both), with the batch split as
    ``xc``'s is and the lanes split over the mesh dims that split any of
    its operands' lanes. Each step of its walk through time is then one
    local op, not one DTensor dispatch."""
    mesh = xc.device_mesh
    ops = [_as_dtensor(t, mesh) for t in (xc, pre_i, pre_r, pre_y)]
    seq, lanes, state, split = [], [], [], 1
    for i in range(mesh.ndim):
        p = ops[0].placements[i]
        if isinstance(p, Shard) and p.dim == 0:
            seq.append(Shard(0))
            lanes.append(Replicate())
            state.append(Shard(0))
        elif (any(isinstance(t.placements[i], Shard)
                  and t.placements[i].dim == 2 for t in ops)
              and xc.shape[2] % (split * mesh.size(i)) == 0):
            split *= mesh.size(i)
            seq.append(Shard(2))
            lanes.append(Shard(0))
            state.append(Shard(1))
        else:
            seq.append(Replicate())
            lanes.append(Replicate())
            state.append(Replicate())
    # lambda's gradient from each rank's rows: partial sums over the mesh
    # dims that split the batch
    lam_grads = [Partial() if isinstance(seq[i], Shard) and seq[i].dim == 0
                 else lanes[i] for i in range(mesh.ndim)]
    run = _local_map(fn, (seq, state), (seq, seq, seq, lanes, seq, state),
                     (seq, seq, seq, lam_grads, seq, state), mesh)
    return run(*(_grad_to(t) for t in ops[:3]),
               _grad_to(_as_dtensor(lam, mesh)), _grad_to(ops[3]),
               _as_dtensor(h0, mesh))


class _VocabParallelNLL(torch.autograd.Function):
    """nll (B_local, S) of local logits (B_local, S, V_local) whose columns
    are the vocab ids [offset, offset + V_local)."""

    @staticmethod
    def forward(ctx, logits, labels, offset, groups):
        vl = logits.shape[-1]
        m = logits.amax(dim=-1)
        for g in groups:
            m = funcol.all_reduce(m, "max", g)
        e = torch.exp(logits - m[..., None])
        se = e.sum(dim=-1)
        local = labels.long() - offset
        inside = (local >= 0) & (local < vl)
        idx = torch.where(inside, local, 0)[..., None]
        zl = torch.where(inside, torch.gather(logits, -1, idx)[..., 0] - m,
                         0.0)
        for g in groups:
            se = funcol.all_reduce(se, "sum", g)
            zl = funcol.all_reduce(zl, "sum", g)
        ctx.save_for_backward(e, se, idx, inside)
        return torch.log(se) - zl

    @staticmethod
    def backward(ctx, grad):
        e, se, idx, inside = ctx.saved_tensors
        g = e / se[..., None]
        g.scatter_add_(-1, idx, -inside.to(g.dtype)[..., None])
        return g * grad[..., None], None, None, None


def vocab_parallel_nll(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """The per-token loss (B, S) of vocab-sharded logits (B, S, V): the
    logsumexp minus the label's logit, in the logits' dtype, as a DTensor
    sharded over the batch as the logits are and replicated over the
    vocab's mesh dims."""
    mesh, placements = logits.device_mesh, logits.placements
    vdim = logits.ndim - 1
    vocab_dims = _shard_dims(placements, vdim)
    rows = tuple(Replicate() if i in vocab_dims else p
                 for i, p in enumerate(placements))
    labels = _as_dtensor(labels, mesh).redistribute(mesh, rows)
    offset, _ = _offset(mesh, vocab_dims, logits.shape[-1])
    nll = _VocabParallelNLL.apply(logits.to_local(), labels.to_local(),
                                  offset, [(mesh, d) for d in vocab_dims
                                           if mesh.size(d) > 1])
    return DTensor.from_local(nll, mesh, rows, run_check=False,
                              shape=labels.shape, stride=labels.stride())


def rows_nll(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """The per-token loss (B, S) of logits (B, S, V) whose vocab no mesh dim
    of size > 1 splits (``common.token_nll``), on each rank's own rows: the
    logsumexp and the label's logit from its local (B_local, S, V) logits,
    the result split over the batch as the logits are, the backward pass
    local. DTensor's rule for ``gather`` would make the backward's
    scatter buffer of the global (B, S, V) shape on every rank. Placements
    on a mesh dim of size 1 are kept as they are: nothing moves."""
    from repro_torch.models.common import token_nll

    mesh = logits.device_mesh
    out = [Shard(0) if _is_shard(p, 0) else Replicate()
           for p in logits.placements]
    labels = _as_dtensor(labels, mesh)
    lab_in = [q if mesh.size(i) == 1 else o
              for i, (q, o) in enumerate(zip(labels.placements, out))]
    lg_in = list(logits.placements)
    return _local_map(token_nll, out, (lg_in, lab_in), (lg_in, lab_in),
                      mesh)(logits, labels)


def write_slots(cache: DTensor, slot: torch.Tensor,
                vals: torch.Tensor) -> DTensor:
    """Write row b's new entry ``vals[b]`` into slot ``slot[b]`` of a
    placed cache (B, T, ...), in place, and return the cache. Each rank
    writes its own shard: the rows of its batch shard and, where the slots
    are split over ranks (the context-parallel fallback of
    ``cache_pspecs``), only a slot that falls in its part. ``vals`` is
    brought to the cache's placement of its dims first (nothing moves where
    it has it already)."""
    mesh, placements = cache.device_mesh, cache.placements
    vals_placements = tuple(
        Replicate() if isinstance(p, Shard) and p.dim == 1
        else Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
        else p for p in placements)
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in placements)
    vals = _as_dtensor(vals, mesh).redistribute(
        mesh, vals_placements).to_local()
    slot = _as_dtensor(slot, mesh).redistribute(mesh, rows).to_local()
    local = cache.to_local()
    r = torch.arange(local.shape[0], device=local.device)
    slot_dims = _shard_dims(placements, 1)
    if not slot_dims:
        local[r, slot] = vals
        return cache
    start, length = _offset(mesh, slot_dims, cache.shape[1])
    j = slot - start
    inside = (j >= 0) & (j < length)
    j = torch.clamp(j, 0, length - 1)
    keep = inside.reshape((-1,) + (1,) * (vals.ndim - 1))
    local[r, j] = torch.where(keep, vals, local[r, j])
    return cache
