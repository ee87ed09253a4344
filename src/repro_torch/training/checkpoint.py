"""Minimal checkpointing: params / optimizer-state trees to .npz, the
counterpart of ``repro.training.checkpoint``: leaves ``p{i}`` (and
``e{i}`` of the extra tree) in ``tree_tensors`` order, and ``__meta__``
JSON. numpy has no bfloat16 of its own, so a bf16 leaf is stored as its
16-bit pattern and ``__meta__`` names every leaf's dtype; loading restores
each leaf bit for bit, on the device of the template's leaf.
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.models.common import tree_map, tree_tensors


def _arrays(tree: Any, prefix: str):
    arrays, dtypes = {}, []
    for i, t in enumerate(tree_tensors(tree)):
        t = t.detach().cpu()
        dtypes.append(str(t.dtype).removeprefix("torch."))
        arrays[f"{prefix}{i}"] = (t.view(torch.int16) if t.dtype ==
                                  torch.bfloat16 else t).numpy()
    return arrays, dtypes


def save_checkpoint(path: str, params: Any, extra: Any = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, dtypes = _arrays(params, "p")
    meta = {"n": len(dtypes), "dtypes": dtypes}
    if extra is not None:
        e_arrays, e_dtypes = _arrays(extra, "e")
        arrays.update(e_arrays)
        meta["extra_n"] = len(e_dtypes)
        meta["extra_dtypes"] = e_dtypes
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def _restore(data, prefix: str, dtypes, template: Any) -> Any:
    n = sum(1 for _ in tree_tensors(template))
    if n != len(dtypes):
        raise ValueError(f"checkpoint holds {len(dtypes)} '{prefix}' "
                         f"leaves, the template {n}")
    index = iter(range(n))

    def one(t: torch.Tensor) -> torch.Tensor:
        i = next(index)
        x = torch.from_numpy(data[f"{prefix}{i}"])
        if dtypes[i] == "bfloat16":
            x = x.view(torch.bfloat16)
        if x.dtype != getattr(torch, dtypes[i]) or x.shape != t.shape:
            raise ValueError(f"checkpoint leaf {prefix}{i} is {x.dtype} "
                             f"{tuple(x.shape)}, the template's "
                             f"{tuple(t.shape)}")
        return x.to(t.device)

    return tree_map(one, template)


def load_checkpoint(path: str, params_template: Any,
                    extra_template: Any = None) -> Tuple[Any, Any]:
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        params = _restore(data, "p", meta["dtypes"], params_template)
        extra = None
        if extra_template is not None and "extra_n" in meta:
            extra = _restore(data, "e", meta["extra_dtypes"],
                             extra_template)
    return params, extra
