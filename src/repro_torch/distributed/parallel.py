"""What the models do differently on DTensors, where the plain form would
gather a sharded operand whole or has no DTensor rule. The plain path never
comes here: each function is reached only with DTensor operands.

* ``vocab_parallel_nll``: the cross entropy of logits sharded over the
  vocab (``logits_pspec``), Megatron's vocab-parallel form. Each rank takes
  its shard's max, sum of exponentials and, where the label falls in its
  shard, the label's logit; three all-reduces of (B, S) over the vocab's
  mesh dims combine them. The logits are never gathered, and the backward
  pass, softmax minus the one-hot label, is local.
* ``write_slots``: a decode step's in-place write of each row's new entry
  into a placed cache, done on each rank's own shard.
* ``embedding``: the vocab-parallel lookup of a placed table, and
  ``stack_layers``: a prefill's per-layer caches stacked shard by shard.
* ``local_attention``: attention run on each rank's rows and heads, and
  ``local_scan``: the RG-LRU recurrence on each rank's rows and lanes.
* ``divide_dim`` and ``merge_dims``: views of a split of heads that
  DTensor cannot take unevenly.
* ``reduce_onto_vocab``: the head's unreduced product brought onto vocab
  shards before the loss.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard


def _as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    """``t`` itself if it is a DTensor, else a plain tensor that every rank
    holds whole (as ``implicit_replication`` takes it), replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _shard_dims(placements, dim: int) -> List[int]:
    """The mesh dims whose placement shards tensor dim ``dim``."""
    return [i for i, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == dim]


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


def vocab_split(logits: torch.Tensor) -> bool:
    """Whether ``logits`` is a DTensor whose last (vocab) dim is split over
    more than one rank."""
    if not isinstance(logits, DTensor):
        return False
    mesh = logits.device_mesh
    return any(mesh.size(d) > 1
               for d in _shard_dims(logits.placements, logits.ndim - 1))


def divide_dim(t: DTensor, dim: int, count: int) -> DTensor:
    """``t``, made whole over each mesh dim of the split of tensor dim
    ``dim`` that would divide ``count`` unevenly (an all-gather; the JAX
    package's partitioner pads instead), so that ``dim`` views as
    (count, ...): DTensor cannot view an uneven split. Nothing moves where
    ``count`` divides."""
    mesh, dim = t.device_mesh, dim % t.ndim
    target, split = list(t.placements), 1
    for i, p in enumerate(target):
        if isinstance(p, Shard) and p.dim == dim:
            if count % (split * mesh.size(i)):
                target[i] = Replicate()
            else:
                split *= mesh.size(i)
    if tuple(target) == tuple(t.placements):
        return t
    return t.redistribute(mesh, target)


class _MergeDims(torch.autograd.Function):
    """Dims ``dim`` and ``dim + 1`` viewed as one, whose backward pass
    brings the gradient to a split that divides the first of them
    (``divide_dim``) before viewing it back: the gradient of a product with
    a weight split over the merged dim arrives split as the weight is,
    which may divide the first unevenly."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.shape, ctx.dim = t.shape, dim
        out = t.reshape(t.shape[:dim] + (-1,) + t.shape[dim + 2:])
        # the strides a plain reshape gives: DTensor's view rule may keep
        # another stride for a dim of size 1 (the (B, 1, H*D) attention
        # output of a decode step: (H*D, D, 1) where the plain tensor has
        # (H*D, H*D, 1)), and at::matmul reads it to decide whether to
        # fold a (B, 1, K) operand into one GEMM or run a batched one,
        # which rounds otherwise
        return DTensor.from_local(out.to_local().contiguous(),
                                  out.device_mesh, out.placements,
                                  run_check=False, shape=out.shape,
                                  stride=_contiguous_strides(out.shape))

    @staticmethod
    def backward(ctx, grad):
        grad = divide_dim(grad, ctx.dim, ctx.shape[ctx.dim])
        return grad.reshape(ctx.shape), None


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, n = [], 1
    for size in reversed(shape):
        strides.append(n)
        n *= size
    return tuple(reversed(strides))


def merge_dims(t: DTensor, dim: int) -> DTensor:
    return _MergeDims.apply(t, dim)


def embedding(table: DTensor, tokens: torch.Tensor) -> DTensor:
    """``table[tokens]`` of a placed table (V, d), Megatron's
    vocab-parallel lookup: each rank looks up the tokens that fall in its
    shard of the vocab (zeros for the rest), so the result holds partial
    sums over the vocab's mesh dims, and is split over the batch as the
    tokens are. The backward pass (an accumulating scatter into the
    table's shard) is local too, where DTensor's rule for it fails in some
    releases."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

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
    run = local_map(lookup, out_placements=out,
                    in_placements=(table_placements, rows),
                    in_grad_placements=(table_grads, rows),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(table, tokens)


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


def local_attention(fn, q, k, v, mask, **kw):
    """``fn(q, k, v, mask, **kw)`` (an attention over q (B, S, H, D) and k,
    v (B, T, Hkv, D), mask None or broadcasting to (B, 1, S, T)) run on each
    rank's own shard, as the JAX package's partitioner runs it: the batch
    split as q's is, the heads split over the mesh dims that split q's or
    k's heads where the kv heads divide, k and v whole over their length.
    Each rank attends its rows and heads alone; DTensor's rules for the
    einsums inside would instead merge a batch split with a head split,
    which some releases cannot view."""
    from torch.distributed.tensor.experimental import local_map

    mesh = next(t for t in (q, k, v) if isinstance(t, DTensor)).device_mesh
    q, k, v = (_as_dtensor(t, mesh) for t in (q, k, v))
    target, batch, split = [], [], 1
    for i in range(mesh.ndim):
        p = q.placements[i]
        if isinstance(p, Shard) and p.dim == 0:
            target.append(Shard(0))
            batch.append(Shard(0))
            continue
        batch.append(Replicate())
        heads = any(isinstance(t.placements[i], Shard)
                    and t.placements[i].dim == 2 for t in (q, k))
        if heads and k.shape[2] % (split * mesh.size(i)) == 0:
            target.append(Shard(2))
            split *= mesh.size(i)
        else:
            target.append(Replicate())
    mask_placements = None
    if isinstance(mask, DTensor):
        mask_placements = [b if mask.shape[0] == q.shape[0]
                           else Replicate() for b in batch]
    # a list is one output's placements (a tuple would be one per output)
    run = local_map(fn, out_placements=target,
                    in_placements=(target, target, target, mask_placements),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(q, k, v, mask, **kw)


def local_scan(fn, xc, pre_i, pre_r, lam, pre_y, h0):
    """``fn(xc, pre_i, pre_r, lam, pre_y, h0)``, the RG-LRU block's gates
    and recurrence (``kernels.ref.rglru_gated_scan``): (B, S, W) operands,
    the (W,) lambda and the (B, W) state, run on each rank's own rows and
    lanes (the recurrence is elementwise in both), with the batch split as
    ``xc``'s is and the lanes split over the mesh dims that split any of
    its operands' lanes. Each step of its walk through time is then one
    local op, not one DTensor dispatch."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

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
    run = local_map(fn, out_placements=(seq, state),
                    in_placements=(seq, seq, seq, lanes, seq, state),
                    in_grad_placements=(seq, seq, seq, lam_grads, seq,
                                        state),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(ops[0], ops[1], ops[2], _as_dtensor(lam, mesh), ops[3],
               _as_dtensor(h0, mesh))


def reduce_onto_vocab(logits: DTensor) -> DTensor:
    """``logits`` with each mesh dim that holds partial sums reduced onto a
    vocab shard (a reduce-scatter), where the vocab divides over it, else
    whole: DTensor may leave the head's product unreduced where its input
    was split over the hidden dim. Nothing moves where no dim is
    partial."""
    from torch.distributed.tensor import Partial

    mesh, vdim = logits.device_mesh, logits.ndim - 1
    target, split = [], 1
    for i, p in enumerate(logits.placements):
        if isinstance(p, Partial):
            fits = logits.shape[vdim] % (split * mesh.size(i)) == 0
            target.append(Shard(vdim) if fits else Replicate())
            split *= mesh.size(i) if fits else 1
        else:
            target.append(p)
            if isinstance(p, Shard) and p.dim == vdim:
                split *= mesh.size(i)
    if tuple(target) == tuple(logits.placements):
        return logits
    return logits.redistribute(mesh, target)


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
