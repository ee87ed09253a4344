"""Turn a JAX-package param tree, given as numpy arrays, into the port's
params, so parity tests run both frameworks on the same weights.

The JAX tree (``repro.models.transformer.DecoderOnlyLM.init``) stacks the
homogeneous layers on a leading axis (``params["layers"][name]`` has shape
(L, ...)) and keeps ``params["prefix"]`` as a list of unstacked layers. The
port keeps a list of per-layer dicts. Matrices stay (in, out) in both.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.common import resolve_device


def to_tensor(a, device="cuda") -> torch.Tensor:
    """numpy array (bfloat16 included, as numpy stores it) -> tensor on
    ``device``, which must be given as ``"cpu"`` where there is no card."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _unstack(tree, i):
    return _map(tree, lambda a: a[i])


def _num_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(np.shape(tree)[0])


def from_jax_params(tree: Any, device="cuda") -> Any:
    """The JAX param tree (leaves as numpy arrays) -> the port's params on
    ``device``. The default is the card, and asking for it without one
    raises; pass ``device="cpu"`` for the plain PyTorch path."""
    device = resolve_device(device)
    out = {k: to_tensor(v, device) for k, v in tree.items()
           if k not in ("layers", "prefix")}
    out["prefix"] = [_map(lp, lambda a: to_tensor(a, device))
                     for lp in tree.get("prefix", [])]
    layers = tree["layers"]
    out["layers"] = [_map(_unstack(layers, i),
                          lambda a: to_tensor(a, device))
                     for i in range(_num_layers(layers))]
    return out
