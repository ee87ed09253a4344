"""Training step factory + a simple host-driven loop, the counterparts of
``repro.training.train_loop``.

``make_train_step(model, cfg)`` returns
    (params, opt_state, batch) -> (params, opt_state, metrics)
which the JAX package ``jit``s; here it runs eagerly. The loss's gradient
comes from ``loss.backward()`` through the models' plain path (with
``cfg.remat`` each layer is recomputed in the backward pass), and the
update writes the params in place (``adamw_update``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.models.blocks import widened_leaves
from repro_torch.models.common import tree_map, tree_tensors
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, init_adamw)


def make_train_step(model, opt_cfg: AdamWConfig = AdamWConfig()
                    ) -> Callable:
    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        for p in tree_tensors(params):
            p.requires_grad_(True)
            p.grad = None
        args = (batch["tokens"], batch["labels"])
        if "frames" in batch:
            args += (batch["frames"],)
        loss = model.loss(params, *args)
        loss.backward()
        grads = tree_map(lambda p: (p.grad if p.grad is not None
                                    else torch.zeros_like(p)), params)
        # values of a narrower dtype held widened: their gradients and new
        # values on that dtype's grid, as the JAX package's leaves are
        narrow = widened_leaves(params, model.cfg)
        with torch.no_grad():
            for p in narrow:
                p.grad.copy_(p.grad.to(model.cfg.weight_dtype))
        params, new_state, gnorm = adamw_update(opt_cfg, params, grads,
                                                opt_state)
        with torch.no_grad():
            for p in narrow:
                p.copy_(p.to(model.cfg.weight_dtype))
        for p in tree_tensors(params):
            p.grad = None
        metrics = {"loss": loss.detach().float(), "grad_norm": gnorm,
                   "step": new_state.step}
        return params, new_state, metrics

    return train_step


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    """A batch of numpy arrays (``synthetic_token_batches``) as tensors on
    ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train(model, params, data_iter, *, steps: int,
          opt_cfg: AdamWConfig = AdamWConfig(),
          log_every: int = 10,
          callback: Optional[Callable] = None):
    """Single-host training loop used by the examples. Batches come from
    ``data_iter`` as numpy arrays and go to the params' device."""
    device = next(tree_tensors(params)).device
    opt_state = init_adamw(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg)
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = to_device(next(data_iter), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            if callback:
                callback(i, m)
    return params, opt_state, history
