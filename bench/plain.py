"""Plain PyTorch pieces that the configurations' references share, and
the seeded drawing of weights. Nothing here imports the program.

A reference computes in fp32 (``prec="fp32"``) with TF32 off, or, as the
control of the comparison that decides ``correct``, in fp8 (``"fp8"``):
every operand of a matrix product and every value written to a cache
rounded to float8 e4m3, with a scale per row of an activation and one per
weight matrix, and the products summed in fp32."""
from __future__ import annotations

import math
from typing import Iterable, List, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor, dims=(-1,)) -> torch.Tensor:
    """``t`` (fp32) rounded to e4m3 with one scale per slice over ``dims``
    (a row of an activation; the whole of a weight matrix)."""
    amax = t.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def act(t: torch.Tensor, prec: str) -> torch.Tensor:
    """An activation as a product or a cache takes it."""
    t = t.float()
    return fp8(t) if prec == "fp8" else t


def weight(w: torch.Tensor, prec: str) -> torch.Tensor:
    """A weight matrix (..., K, N) widened to fp32, or rounded to e4m3."""
    w = w.float()
    return fp8(w, dims=(-2, -1)) if prec == "fp8" else w


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    return act(x, prec) @ weight(w, prec)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (..., D) at positions ``pos`` (broadcast to
    x's leading dims), the first and second halves of D rotated together."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = pos.float()[..., None] * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def swiglu(x: torch.Tensor, w_gate, w_up, w_out, prec: str) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate, prec)) * mm(x, w_up, prec), w_out, prec)


# ---------------------------------------------------------------------------
# Weights: drawn on the device from the seed, in a few large calls
# ---------------------------------------------------------------------------

#: a leaf: (its path in the params tree, shape, dtype, how it is drawn)
#: how: ("normal", std) | ("around_one", spread) | ("uniform", lo, hi)
#:      | ("log_uniform", lo, hi): the log of a value log-uniform in [lo, hi]
#:      | ("softplus_inverse_log_uniform", lo, hi): x with softplus(x)
#:        log-uniform in [lo, hi]
Leaf = Tuple[tuple, tuple, torch.dtype, tuple]
CHUNK = 1 << 30


def draw(leaves: List[Leaf], gen: torch.Generator, device,
         into=None) -> dict:
    """The params tree of ``leaves``, each a view of one flat buffer per
    dtype, drawn from ``gen`` in chunks of at most 2**30 values: standard
    normals for the bf16 leaves, uniforms for the fp32 ones, then shaped
    in place. ``into``, a tree ``draw`` made before, is drawn again in
    place (its tensors, and so any graph that holds them, stay)."""
    flats = {}
    for dtype in {leaf[2] for leaf in leaves}:
        n = sum(math.prod(s) for _, s, d, _ in leaves if d == dtype)
        flat = (_flat(into, dtype) if into is not None
                else torch.empty(n, dtype=dtype, device=device))
        for a in range(0, n, CHUNK):
            part = flat[a:a + CHUNK]
            if dtype == torch.float32:
                part.uniform_(0.0, 1.0, generator=gen)
            else:
                part.normal_(0.0, 1.0, generator=gen)
        flats[dtype] = flat
    tree, offs = {} if into is None else into, {d: 0 for d in flats}
    with torch.no_grad():
        for path, shape, dtype, how in leaves:
            n = math.prod(shape)
            t = flats[dtype][offs[dtype]:offs[dtype] + n].view(shape)
            offs[dtype] += n
            _shape_values(t, how)
            if into is None:
                _put(tree, path, t)
    return tree


def _shape_values(t: torch.Tensor, how: tuple) -> None:
    kind = how[0]
    if kind == "normal":
        t.mul_(how[1])
    elif kind == "around_one":
        t.mul_(how[1]).add_(1.0)
    elif kind == "uniform":
        t.mul_(how[2] - how[1]).add_(how[1])
    elif kind == "log_uniform":
        t.mul_(math.log(how[2]) - math.log(how[1])).add_(
            math.log(how[1]))
    elif kind == "softplus_inverse_log_uniform":
        # x with softplus(x) log-uniform in [lo, hi]
        t.mul_(math.log(how[2]) - math.log(how[1])).add_(
            math.log(how[1])).exp_().expm1_().log_()
    else:
        raise ValueError(f"unknown draw {kind!r}")


def _put(tree: dict, path: tuple, t: torch.Tensor) -> None:
    node = tree
    for i, key in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(node, list):
            while len(node) <= key:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        node.append(t)
    else:
        node[path[-1]] = t


def _flat(tree, dtype) -> torch.Tensor:
    """The flat buffer under the leaves of ``dtype`` of a drawn tree."""
    for t in leaves_of(tree):
        if t.dtype == dtype:
            base = t._base if t._base is not None else t
            return base
    raise KeyError(dtype)


def leaves_of(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from leaves_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves_of(v)
