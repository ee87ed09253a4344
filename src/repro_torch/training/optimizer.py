"""AdamW on the port's param trees, the JAX package's own math
(``repro.training.optimizer``) in fp32 tensor ops, no ``torch.optim``.

State is a tree matching params (m, v moments, fp32 even for bf16 params)
plus a scalar step on the params' device. ``adamw_update`` computes each
new value as the reference does, step by step in fp32, and writes it into
the param and moment tensors in place (one copy of each, not two), so
nothing in it reads a value on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.common import is_dtensor, tree_map, tree_tensors


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # moments in fp32 even when params are bf16
    moment_dtype: str = "float32"


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Any
    v: Any


def init_adamw(params: Any, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    dt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = next(tree_tensors(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree: Any) -> torch.Tensor:
    """The l2 norm over every leaf; placed leaves (DTensors, each placed as
    its param) sum their squares shard by shard
    (``distributed.parallel.global_norm``)."""
    if is_dtensor(next(tree_tensors(tree))):
        from repro_torch.distributed import parallel
        return parallel.global_norm(tree)
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_tensors(tree)))


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: AdamWState) -> Tuple[Any, AdamWState, torch.Tensor]:
    """One AdamW step with global-norm clipping and linear warmup. Writes
    the new params and moments into their tensors and returns them, the
    new state and the gradients' global norm (before the clip)."""
    step = state.step + 1
    grads = list(tree_tensors(grads))
    if is_dtensor(grads[0]):
        # a placed gradient as its param is placed (a norm's weight's is
        # left a partial sum over the batch by DTensor's own rules)
        from repro_torch.distributed import parallel
        grads = parallel.placed_as(grads, params)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    with torch.no_grad():
        for p, g, m, v in zip(tree_tensors(params), grads,
                              tree_tensors(state.m), tree_tensors(state.v)):
            # each temporary is freed before the next is made: the
            # largest leaf's (the embedding, the lm_head) is 1.6 GB in fp32
            g = g.float() * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            del g
            mh = m / b1c
            vh = v / b2c
            delta = mh.div_(vh.sqrt_().add_(cfg.eps))
            del vh
            delta.add_(cfg.weight_decay * p.float()).mul_(lr)
            p.copy_(p.float() - delta)
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
