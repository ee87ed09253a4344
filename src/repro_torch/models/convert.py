"""Turn a JAX-package param tree, given as numpy arrays, into the port's
params, so parity tests run both frameworks on the same weights.

The JAX trees stack homogeneous layers on a leading axis: ``layers`` of
``DecoderOnlyLM`` and ``MambaLM`` (each leaf (L, ...), nested dicts such
as Mamba's ``mixer`` included) and ``units`` of ``HybridLM`` (a dict of
``l0``/``l1``/``l2`` layer dicts, each leaf (n_units, ...)). ``prefix``
(dense) and ``tail`` (hybrid) are lists of unstacked layers. The port keeps
a list of per-layer (or per-unit) dicts for a stacked key, and the lists as
they are. Matrices stay (in, out) in both, and every leaf keeps its dtype
(Mamba's ``A_log``, ``D`` and ``dt_bias`` are fp32 in any config).
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


_STACKED = ("layers", "units")     # stacked on a leading axis


def from_jax_params(tree: Any, device="cuda") -> Any:
    """The JAX param tree (leaves as numpy arrays) -> the port's params on
    ``device``. The default is the card, and asking for it without one
    raises; pass ``device="cpu"`` for the plain PyTorch path."""
    device = resolve_device(device)

    def conv(a):
        return to_tensor(a, device)

    out = {}
    for k, v in tree.items():
        if k in _STACKED:
            out[k] = [_map(_unstack(v, i), conv)
                      for i in range(_num_layers(v))]
        else:
            out[k] = _map(v, conv)
    return out
