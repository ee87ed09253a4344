"""The comparison that decides ``correct``: what the timed path left,
against the configuration's plain fp32 reference run over the same inputs.

A run hands the reference the weights it drew and the inputs the engine
fed the decode steps (token 0, and the slot each row wrote: the position
``TorchBackend`` derives from each request's context). The reference
works the rest out again. Numbers compared, each with its limit from
``limits/<cell>.json``:

- ``cache_err``: the state the decode graph left (every layer's cache or
  SSM state, every row), its relative L2 error, the worse of the cache's
  leaves;
- ``logits_err``: the last decode step's logits (every row), their
  relative L2 error;
- ``prefill_err``: each prefill bucket's first forward in the window (its
  logits at every position), the worst bucket's relative L2 error;
- ``token_gap``: the token the program would serve greedily at each of
  those rows and positions (its logits' argmax), by how far the
  reference's logit of it lies below the reference's best, in standard
  deviations of the reference's logits there; the widest gap;
- ``tokens_miscounted``: the engine's count of output tokens and finished
  requests in the window against the harness's, plus, over every finished
  request, the gap between the tokens it got and its output length (0).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

NUMBERS = ("cache_err", "logits_err", "prefill_err", "token_gap",
           "head_residual", "tokens_miscounted")


def _rows(p: torch.Tensor, r: torch.Tensor):
    """Per row of p (B, ...): the squared error against r (B or 1, ...),
    whose dim 1 may be shorter (slots never written: zeros there), and
    r's squared norm."""
    p = p.float()
    dims = tuple(range(1, p.dim()))
    s = r.shape[1]
    d2 = ((p[:, :s] - r) ** 2).sum(dims)
    if s < p.shape[1]:
        d2 = d2 + (p[:, s:] ** 2).sum(dims)
    return d2, (r ** 2).sum(dims).expand(p.shape[0])


def rel(p: torch.Tensor, r: torch.Tensor) -> float:
    """The relative L2 error of p against r, over every row."""
    d2, n2 = _rows(p, r)
    return math.sqrt(float(d2.sum() / n2.sum().clamp(min=1e-30)))


def gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """The widest gap, over the rows of p (N, V) against r (N or 1, V), of
    the reference's logit of p's argmax below the reference's best, over
    the standard deviation of the reference's row."""
    r = r.float().expand(p.shape[0], -1)
    pick = p.float().argmax(-1, keepdim=True)
    g = (r.max(-1).values - r.gather(-1, pick)[:, 0]) / r.std(-1)
    return float(g.max())


def head_residual(logits: torch.Tensor, head: torch.Tensor) -> float:
    """How far logits (N, V) lie from every output the reference's head
    (d, V) can give: the residual of their least-squares fit by g @ head,
    its largest entry over the standard deviation of its row."""
    w = head.double()
    lg = logits.double()
    g = torch.linalg.solve(w @ w.t(), w @ lg.t()).t()
    res = lg - g @ w
    return float((res.abs().amax(-1) / lg.std(-1)).max())


def model_numbers(model, cfg: dict, params, pos: torch.Tensor,
                  layers: List[List[torch.Tensor]], logits: torch.Tensor,
                  prefill: Dict[int, torch.Tensor],
                  teacher=None) -> Dict[str, Optional[float]]:
    """The numbers of what a run left (``layers``: each layer's cache
    leaves, (B, ...); ``logits``: the last decode step's (B, V);
    ``prefill``: bucket -> its forward's logits (n, V)) against the fp32
    reference, which follows ``teacher`` (default ``layers``), the
    program's state, where the configuration's reference follows one.
    ``cache_err`` covers the configuration's ``CACHE_LAYERS`` leading
    layers (all where the configuration's module sets none);
    ``cache_err_all`` and ``by_layer`` (each layer's) are kept for the
    record."""
    err: Dict[int, torch.Tensor] = {}
    nrm: Dict[int, torch.Tensor] = {}
    by_layer: List[float] = []
    lead = getattr(model, "CACHE_LAYERS", None) or len(layers)

    def on_layer(i, refs):
        worst = 0.0
        for k, (p, r) in enumerate(zip(layers[i], refs)):
            d2, n2 = _rows(p, r)
            if i < lead:
                err[k] = err.get(k, 0) + d2
                nrm[k] = nrm.get(k, 0) + n2
            err[k, "all"] = err.get((k, "all"), 0) + d2
            nrm[k, "all"] = nrm.get((k, "all"), 0) + n2
            worst = max(worst, math.sqrt(float(d2.sum() / n2.sum()
                                               .clamp(min=1e-30))))
        by_layer.append(worst)

    def worst(keys):
        return max(math.sqrt(float(err[k].sum() / nrm[k].sum()
                                   .clamp(min=1e-30))) for k in keys)

    with torch.no_grad():
        out = model.replay(params, cfg, pos, on_layer=on_layer,
                           teacher=layers if teacher is None else teacher)
        head = model.head(params, cfg)
        logit = rel(logits, out["logits"][0])
        tok = gap(logits, out["logits"][0])
        resid = head_residual(logits, head)
        pre = None
        for n, lg in sorted(prefill.items()):
            steps = torch.arange(n, device=pos.device)
            ref = model.replay(params, cfg, steps[:, None],
                               logits_at=steps)["logits"][:, 0]
            e = rel(lg.reshape(1, -1), ref.reshape(1, -1))
            pre = e if pre is None else max(pre, e)
            tok = max(tok, gap(lg, ref))
            resid = max(resid, head_residual(lg, head))
    return {"cache_err": worst([k for k in err if isinstance(k, int)]),
            "logits_err": logit, "prefill_err": pre, "token_gap": tok,
            "head_residual": resid,
            "cache_err_all": worst([k for k in err if isinstance(k, tuple)]),
            "by_layer": by_layer}


def control_outputs(model, cfg: dict, params, pos: torch.Tensor,
                    buckets, teacher) -> tuple:
    """The control put in the program's place: the reference in fp8 over
    the same inputs (following the program's state ``teacher`` where the
    reference follows one), its (layers, logits, prefill) as
    ``model_numbers`` takes a run's."""
    layers: List[List[torch.Tensor]] = []
    with torch.no_grad():
        out = model.replay(params, cfg, pos, prec="fp8", teacher=teacher,
                           on_layer=lambda i, refs: layers.append(refs))
        prefill = {}
        for n in buckets:
            steps = torch.arange(n, device=pos.device)
            prefill[n] = model.replay(params, cfg, steps[:, None],
                                      prec="fp8", logits_at=steps
                                      )["logits"][:, 0]
    rows = pos.shape[1]
    layers = [[t.expand(rows, *t.shape[1:]) for t in leaves]
              for leaves in layers]
    return layers, out["logits"][0].expand(rows, -1), prefill


def verdict(numbers: Dict[str, Optional[float]], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) over the numbers that the cell's
    limits name: each at or below its limit. ``prefill_err`` can be
    missing (no prefill in the window); any other missing number fails."""
    lines = [(k, numbers.get(k), limits[k]) for k in NUMBERS
             if k in limits]
    ok = all(v is not None and v <= lim and not math.isnan(v)
             for k, v, lim in lines if k != "prefill_err" or v is not None)
    return ok, [x for x in lines if x[1] is not None]
