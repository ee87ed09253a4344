"""DeepSeek-V2-Lite as the benchmark runs it: its weights, drawn from the
seed in the program's layout; its plain fp32 reference; and the
operations a decode step needs.

The reference is plain PyTorch and follows the published description
(arXiv:2405.04434) as ``deepseek-v2-lite-16b.json`` states it: MLA with
the latents RMS-normed and one rotary key shared by the heads, the first
layer a dense SwiGLU FFN, the others 64 routed experts (top 6 of a softmax
router, their weights renormalised) plus 2 shared. It computes what the
timed path computes, the decode steps of a run one after another against
the latent cache, but layer by layer over all the steps at once: a step's
query attends, in its row, to the latest entry written to each slot up to
and including its own position, and to slots never written since the
cache was zeroed, which hold zeros (score 0, value 0). Attention runs in
the absorbed form (each query taken into the latent space through the
key up-projection), which is the same sum as up-projecting every cached
latent.

With random weights the decode steps of this model are chaotic: the
top-6 routing of 64 experts flips on rounding, and over a run's hundreds
of steps, each attending to entries that earlier steps wrote, a flip
anywhere spreads to everything after it, so a reference run on its own
from the zeroed cache ends far from any run of the program, in fp32 as in
bf16. So, given the program's cache as the run left it (``teacher``), the
reference follows the program step by step: a step attends to the entry
that the program left in each slot where that entry is the slot's last
(it is then what the slot held at the step), and to its own
recomputation of every entry the run overwrote later and of the step's
own entry. Each step is then one pass through the layers from the
program's own state, and its entries and logits are compared.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from bench import plain

#: the leading layers whose cache ``cache_err`` compares: the dense layer,
#: the first routed layer and the one after it, where the fp8 control's
#: error is 4-15 times the program's; deeper, routing flips on rounding
#: cascade (module docstring) and the gap narrows, to 2.4-3 times at the
#: last layer and over the whole cache, too little to set a limit between
CACHE_LAYERS = 3

def _mc(cfg: dict) -> dict:
    return cfg["model_config"]


def leaves(cfg: dict):
    m = _mc(cfg)
    d, H, V = m["d_model"], m["num_heads"], m["vocab_size"]
    r, nope, rp, vd = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                       m["qk_rope_head_dim"], m["v_head_dim"])
    E, f, fd = m["num_experts"], m["moe_d_ff"], m["d_ff"]
    fs = f * m["num_shared_experts"]
    bf = torch.bfloat16
    # the projections back into the residual stream scaled by
    # 1/sqrt(2 x layers), as GPT-2 and Megatron-LM initialise them
    res = (2 * m["num_layers"]) ** -0.5
    out = [(("embed",), (V, d), bf, ("normal", 0.02)),
           (("final_norm",), (d,), bf, ("around_one", 0.1)),
           (("lm_head",), (d, V), bf, ("normal", d ** -0.5))]

    def ffn(path, width):
        return [(path + ("w_in",), (d, width), bf, ("normal", d ** -0.5)),
                (path + ("w_out",), (width, d), bf,
                 ("normal", res * width ** -0.5)),
                (path + ("w_gate",), (d, width), bf, ("normal", d ** -0.5))]

    for i in range(m["num_layers"]):
        dense = i < m["first_k_dense"]
        p = ("prefix", i) if dense else ("layers", i - m["first_k_dense"])
        out += [(p + ("attn_norm",), (d,), bf, ("around_one", 0.1)),
                (p + ("ffn_norm",), (d,), bf, ("around_one", 0.1)),
                (p + ("attn", "wq"), (d, H * (nope + rp)), bf,
                 ("normal", d ** -0.5)),
                (p + ("attn", "w_dkv"), (d, r + rp), bf,
                 ("normal", d ** -0.5)),
                (p + ("attn", "kv_norm"), (r,), bf, ("around_one", 0.1)),
                (p + ("attn", "w_uk"), (r, H * nope), bf,
                 ("normal", r ** -0.5)),
                (p + ("attn", "w_uv"), (r, H * vd), bf,
                 ("normal", r ** -0.5)),
                (p + ("attn", "wo"), (H * vd, d), bf,
                 ("normal", res * (H * vd) ** -0.5))]
        if dense:
            out += ffn(p + ("ffn",), fd)
        else:
            out += [(p + ("moe", "router"), (d, E), bf, ("normal", 0.02)),
                    (p + ("moe", "w_gate"), (E, d, f), bf,
                     ("normal", d ** -0.5)),
                    (p + ("moe", "w_in"), (E, d, f), bf,
                     ("normal", d ** -0.5)),
                    (p + ("moe", "w_out"), (E, f, d), bf,
                     ("normal", res * f ** -0.5))]
            out += ffn(p + ("moe", "shared"), fs)
    return out


def make_weights(cfg: dict, gen: torch.Generator, device, into=None):
    return plain.draw(leaves(cfg), gen, device, into)


def _layers(params):
    return params["prefix"] + params["layers"]


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

def _slots(pos: torch.Tensor):
    """For each row's log of written slots ``pos`` (T, R): M (R, T, T),
    whether step t reads step w's entry (w <= t, w's slot at or below t's
    position, and not written again by t); n0 (R, T), the slots at or
    below t's position never written by t; last (T, R), whether w's entry
    is the one its slot holds at the end."""
    T, R = pos.shape
    dev = pos.device
    steps = torch.arange(T, device=dev)
    key = pos * T + steps[:, None]                     # slot-major order
    order = torch.argsort(key, dim=0)
    s_sorted = torch.gather(pos, 0, order)
    same_next = torch.zeros_like(pos, dtype=torch.bool)
    same_next[:-1] = s_sorted[1:] == s_sorted[:-1]
    nxt_sorted = torch.full_like(pos, T)
    nxt_sorted[:-1] = torch.where(same_next[:-1], order[1:], T)
    nxt = torch.empty_like(pos)
    nxt.scatter_(0, order, nxt_sorted)                 # (T, R)
    p_r, n_r = pos.t(), nxt.t()                        # (R, T)
    t_ = steps[None, :, None]
    w_ = steps[None, None, :]
    M = ((w_ <= t_) & (p_r[:, None, :] <= p_r[:, :, None])
         & (n_r[:, None, :] > t_))
    n0 = p_r + 1 - M.sum(-1)
    return M, n0, nxt == T


def _moe(lp, m, x: torch.Tensor, prec: str) -> torch.Tensor:
    """The routed experts plus the shared ones on tokens x (N, d)."""
    E, K = m["num_experts"], m["top_k"]
    probs = torch.softmax(plain.mm(x, lp["router"], prec), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = vals[:, :K], idx[:, :K]
    w = w / w.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    e_flat = idx.reshape(-1)
    tok = torch.arange(x.shape[0], device=x.device).repeat_interleave(K)
    order = torch.argsort(e_flat, stable=True)
    counts = torch.bincount(e_flat, minlength=E).tolist()
    start = 0
    for e, n in enumerate(counts):
        if n:
            sel = order[start:start + n]
            t = tok[sel]
            o = plain.swiglu(x[t], lp["w_gate"][e], lp["w_in"][e],
                             lp["w_out"][e], prec)
            y.index_add_(0, t, o * w.reshape(-1)[sel, None])
            start += n
    sh = lp["shared"]
    return y + plain.swiglu(x, sh["w_gate"], sh["w_in"], sh["w_out"], prec)


def _attend(ap, m, h, pos, M, n0, prec, rows_per_block, given=None):
    """One MLA layer over every step: h (T, R, d) normed; returns the
    output (T, R, d) and the entries written, c (T, R, rank) and kr
    (T, R, rope). ``given`` (c, kr, last): the program's entries where
    each step wrote, (T, R, width), and whether each is its slot's last;
    the steps attend to those in place of the ones computed here, except
    their own."""
    T, R, d = h.shape
    H, nope, rp, vd, r = (m["num_heads"], m["qk_nope_head_dim"],
                          m["qk_rope_head_dim"], m["v_head_dim"],
                          m["kv_lora_rank"])
    theta = m["rope_theta"]
    q = plain.mm(h, ap["wq"], prec).view(T, R, H, nope + rp)
    q_nope = q[..., :nope]
    q_rope = plain.rope(q[..., nope:], pos[..., None], theta)
    ckv = plain.mm(h, ap["w_dkv"], prec)
    c = plain.act(plain.rmsnorm(ckv[..., :r], ap["kv_norm"], m["norm_eps"]),
                  prec)
    kr = plain.act(plain.rope(ckv[..., r:], pos, theta), prec)
    w_uk = plain.weight(ap["w_uk"], prec).view(r, H, nope)
    w_uv = plain.weight(ap["w_uv"], prec).view(r, H, vd)
    q_lat = torch.einsum("trhn,khn->trhk", q_nope, w_uk)
    scale = (nope + rp) ** -0.5
    gc, gk = c, kr
    if given is not None:
        keep = given[2][..., None]
        gc = torch.where(keep, given[0], c)
        gk = torch.where(keep, given[1], kr)
    own = (torch.einsum("trhk,trk->rth", q_lat, c)
           + torch.einsum("trhd,trd->rth", q_rope, kr)) * scale
    o_lat = torch.empty((T, R, H, r), device=h.device)
    for a in range(0, R, rows_per_block):
        b = min(R, a + rows_per_block)
        s = (torch.einsum("trhk,wrk->rthw", q_lat[:, a:b], gc[:, a:b])
             + torch.einsum("trhd,wrd->rthw", q_rope[:, a:b], gk[:, a:b]))
        s = s * scale
        # a step reads its own entry as it computes it
        torch.diagonal(s, dim1=1, dim2=3).copy_(
            own[a:b].transpose(1, 2))
        s = torch.where(M[a:b, :, None, :], s, float("-inf"))
        zero = torch.where(n0[a:b] > 0, n0[a:b].float().log(),
                           float("-inf"))                     # (r, T)
        s = torch.cat([s, zero[:, :, None, None].expand(-1, -1, H, 1)],
                      dim=-1)
        p = torch.softmax(s, dim=-1)[..., :T]
        o = torch.einsum("rthw,wrk->trhk", p, gc[:, a:b])
        pd = torch.diagonal(p, dim1=1, dim2=3).permute(2, 0, 1)  # (T,r,H)
        o_lat[:, a:b] = o + pd[..., None] * (c[:, a:b] - gc[:, a:b])[
            :, :, None, :]
    o = torch.einsum("trhk,khv->trhv", o_lat, w_uv).reshape(T, R, H * vd)
    return plain.mm(o, ap["wo"], prec), c, kr


def replay(params, cfg: dict, pos: torch.Tensor, *, prec: str = "fp32",
           logits_at: Optional[torch.Tensor] = None,
           on_layer: Optional[Callable] = None, teacher=None,
           rows_per_block: int = 8) -> Dict[str, torch.Tensor]:
    """The decode steps of a run, token 0 in every row, from a zeroed
    cache: ``pos`` (T, R) the slot each step writes in each row (its
    position, clamped to the cache). Returns the logits (len(logits_at),
    R, V) of the steps ``logits_at`` (default: the last). ``on_layer(i,
    leaves)`` receives each layer's cache as the run leaves it, (R, slots,
    ...) per leaf, in the program's order (c_kv, k_rope), slots past the
    highest written one left out (they hold zeros on both sides).
    ``teacher``: the program's cache per layer as the run left it
    (``program_cache_layers``), which the steps follow (module
    docstring)."""
    plain.no_tf32()
    m = _mc(cfg)
    T, R = pos.shape
    eps = m["norm_eps"]
    M, n0, last = _slots(pos)
    if logits_at is None:
        logits_at = torch.tensor([T - 1], device=pos.device)
    x = params["embed"][0].float().expand(T, R, -1).clone()
    slots = int(pos.max()) + 1
    rows = torch.arange(R, device=pos.device)
    for i, lp in enumerate(_layers(params)):
        given = None
        if teacher is not None:
            # the program's last entry of each slot, where step w wrote it
            given = tuple(t[rows[None, :], pos].float()
                          for t in teacher[i]) + (last,)
        h = plain.rmsnorm(x, lp["attn_norm"], eps)
        a, c, kr = _attend(lp["attn"], m, h, pos, M, n0, prec,
                           rows_per_block, given)
        x = x + a
        h = plain.rmsnorm(x, lp["ffn_norm"], eps).reshape(T * R, -1)
        if "moe" in lp:
            f = _moe(lp["moe"], m, h, prec)
        else:
            f = plain.swiglu(h, lp["ffn"]["w_gate"], lp["ffn"]["w_in"],
                             lp["ffn"]["w_out"], prec)
        x = x + f.reshape(T, R, -1)
        if on_layer is not None:
            on_layer(i, [_final(c, pos, last, slots),
                         _final(kr, pos, last, slots)])
    h = plain.rmsnorm(x[logits_at], params["final_norm"], eps)
    return {"logits": plain.mm(h, params["lm_head"], prec)}


def _final(entries, pos, last, slots):
    """(R, slots, width): the latest entry of each slot, zeros where none."""
    T, R, W = entries.shape
    out = torch.zeros((R, slots, W), device=entries.device)
    t, r = last.nonzero(as_tuple=True)
    out[r, pos[t, r]] = entries[t, r]
    return out


def head(params, cfg: dict) -> torch.Tensor:
    """The output head as the last norm's output meets it: (d, V) fp32,
    the final norm's weight folded in."""
    return params["final_norm"].float()[:, None] * params["lm_head"].float()


def program_cache_layers(cache):
    """The program's cache per layer, in ``replay``'s order: [c_kv,
    k_rope], each (B, slots, width)."""
    for c in cache["prefix"]:
        yield [c.c_kv, c.k_rope]
    st = cache["scanned"]
    for i in range(st.c_kv.shape[0]):
        yield [st.c_kv[i], st.k_rope[i]]


# ---------------------------------------------------------------------------
# Operations of one decode step
# ---------------------------------------------------------------------------

def decode_flops(cfg: dict, contexts) -> float:
    """The operations one decode step needs for rows whose contexts (cached
    tokens) are ``contexts``: every matrix product of the token's path at
    the published widths, through the active experts only (top 6 and the 2
    shared), and attention over each row's cached tokens and its own,
    (nope + rope) wide for the scores and v wide for the values; the new
    latent's keys and values up-projected once, none of the cached ones."""
    m = _mc(cfg)
    d, H, V = m["d_model"], m["num_heads"], m["vocab_size"]
    r, nope, rp, vd = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                       m["qk_rope_head_dim"], m["v_head_dim"])
    f, fd, E, K = m["moe_d_ff"], m["d_ff"], m["num_experts"], m["top_k"]
    fs = f * m["num_shared_experts"]
    mla = 2 * (d * H * (nope + rp) + d * (r + rp) + r * H * (nope + vd)
               + H * vd * d)
    moe = 2 * (d * E + 3 * d * f * K + 3 * d * fs)
    dense = 2 * 3 * d * fd
    L, Ld = m["num_layers"], m["first_k_dense"]
    per_token = L * mla + Ld * dense + (L - Ld) * moe + 2 * d * V
    attn = sum(2 * L * H * (c + 1) * (nope + rp + vd) for c in contexts)
    return float(per_token * len(contexts) + attn)
