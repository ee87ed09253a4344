"""DeepSeek-V3 as the benchmark runs it: one H100's share of an EP32 x PP4
deployment (``deepseek-v3-671b.json``), its weights drawn from the seed in
the program's layout, its plain fp32 reference, and the operations a
decode step needs.

The reference is plain PyTorch and follows the published description
(arXiv:2412.19437) as the configuration's file states it: MLA with
compressed queries (q = W_qb . RMSNorm(W_qa . x)) and latents, one rotary
key shared by the heads, the first 3 layers dense SwiGLU FFNs, the others
a sigmoid router over 256 experts (the choice by score plus correction
bias, within the 4 best of 8 groups of 32, a group scored by its two best;
the top 8 weighted by their unbiased scores, renormalised, times 2.5), of
which the 8 held here (experts 0-7) add their part, plus the shared
expert. Attention runs in the absorbed form (each query taken into the
latent space through the key up-projection), which is the same sum as
up-projecting every cached latent.

A run's decode steps cannot all be recomputed in fp32: at 64 rows, 128
heads and thousands of steps each attending to the entries of the ones
before it, the work is some 10^15 operations. And as with DeepSeek-V2-Lite
(``deepseek-v2-lite-16b.py``), routing flips on rounding, so the reference
follows the program's cache (``teacher``). It recomputes, in every row,
up to ``STEPS_PER_ROW`` of the steps whose view of the cache the program's
final cache still holds: steps after which no step of the row writes a
slot at or below theirs (always the last step). Such a step attended to
the final cache's slots up to its own position (slots never written hold
zeros, as on the card), and its own entry is the one the final cache
holds at its position. The reference runs each such step's token through
every layer from the program's cache, its own entry recomputed, and
compares its entries: each layer's reference cache is the program's with
those entries put in (the rest, which the reference does not recompute,
equal on both sides). The last step's logits are compared in every row.

Without ``teacher`` (a prefill bucket's forward: step t at position t),
the steps attend causally to each other's entries, from no cache.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from bench import plain
from bench.cell import BENCH, load_module

_v2 = load_module(BENCH / "configs" / "deepseek-v2-lite-16b.py", "config")
head = _v2.head
program_cache_layers = _v2.program_cache_layers

#: the leading layers whose cache ``cache_err`` compares: all 16. At the
#: cell's size every layer's reading lies 3.5 times or more below the fp8
#: control's (the program's worst over 16 seeds against the control's best
#: over 4: 0.0004 / 0.0053 at layer 0 to 0.0109 / 0.0380 at layer 15), where
#: DeepSeek-V2-Lite's reference, which recomputes every step, loses that
#: margin past its third layer: a step recomputed from the program's own
#: cache carries no routing flip of an earlier step
CACHE_LAYERS = 16
#: steps recomputed a row, the last among them
STEPS_PER_ROW = 16
#: the router's correction bias is drawn uniform in [-BIAS, BIAS]
BIAS = 0.05


def _mc(cfg: dict) -> dict:
    return cfg["model_config"]


def leaves(cfg: dict):
    m = _mc(cfg)
    d, H, V = m["d_model"], m["num_heads"], m["vocab_size"]
    r, nope, rp, vd = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                       m["qk_rope_head_dim"], m["v_head_dim"])
    ql = m["q_lora_rank"]
    E, Ea, f, fd = (m["num_experts"], m["router_experts"], m["moe_d_ff"],
                    m["d_ff"])
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
                (p + ("attn", "wq_a"), (d, ql), bf, ("normal", d ** -0.5)),
                (p + ("attn", "q_norm"), (ql,), bf, ("around_one", 0.1)),
                (p + ("attn", "wq_b"), (ql, H * (nope + rp)), bf,
                 ("normal", ql ** -0.5)),
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
            out += [(p + ("moe", "router"), (d, Ea), bf, ("normal", 0.02)),
                    (p + ("moe", "e_score_correction_bias"), (Ea,),
                     torch.float32, ("uniform", -BIAS, BIAS)),
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


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

def route(lp, m, x: torch.Tensor, prec: str):
    """The published router on tokens x (N, d): each token's weights and
    experts (N, K), over all ``router_experts``."""
    Ea, K, G = m["router_experts"], m["top_k"], m["n_group"]
    s = torch.sigmoid(plain.mm(x, lp["router"], prec))
    b = (s + lp["e_score_correction_bias"].float()).view(-1, G, Ea // G)
    best2 = b.topk(2, dim=-1).values.sum(-1)                     # (N, G)
    rank = torch.argsort(torch.argsort(best2, dim=-1, descending=True,
                                       stable=True), dim=-1)
    b = b.masked_fill((rank >= m["topk_group"])[..., None], float("-inf"))
    idx = torch.sort(b.view(-1, Ea), dim=-1, descending=True,
                     stable=True).indices[:, :K]
    w = s.gather(-1, idx)
    return w / w.sum(-1, keepdim=True) * m["routed_scaling_factor"], idx


def _moe(lp, m, x: torch.Tensor, prec: str) -> torch.Tensor:
    """This chip's part of the routed experts (those below
    ``num_experts``), plus the shared expert, on tokens x (N, d)."""
    w, idx = route(lp, m, x, prec)
    y = torch.zeros_like(x)
    for e in range(m["num_experts"]):
        tok, k = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            o = plain.swiglu(x[tok], lp["w_gate"][e], lp["w_in"][e],
                             lp["w_out"][e], prec)
            y.index_add_(0, tok, o * w[tok, k][:, None])
    sh = lp["shared"]
    return y + plain.swiglu(x, sh["w_gate"], sh["w_in"], sh["w_out"], prec)


def _project(ap, m, h, pos, prec):
    """The queries in the latent space and the new entries of tokens h
    (..., d) at positions ``pos`` (...): q_lat (..., H, R), q_rope (..., H,
    rope), c (..., R), kr (..., rope)."""
    H, nope, rp, r = (m["num_heads"], m["qk_nope_head_dim"],
                      m["qk_rope_head_dim"], m["kv_lora_rank"])
    theta, eps = m["rope_theta"], m["norm_eps"]
    cq = plain.rmsnorm(plain.mm(h, ap["wq_a"], prec), ap["q_norm"], eps)
    q = plain.mm(cq, ap["wq_b"], prec).view(*h.shape[:-1], H, nope + rp)
    q_rope = plain.rope(q[..., nope:], pos[..., None], theta)
    ckv = plain.mm(h, ap["w_dkv"], prec)
    c = plain.act(plain.rmsnorm(ckv[..., :r], ap["kv_norm"], eps), prec)
    kr = plain.act(plain.rope(ckv[..., r:], pos, theta), prec)
    w_uk = plain.weight(ap["w_uk"], prec).view(r, H, nope)
    q_lat = torch.einsum("...hn,khn->...hk", q[..., :nope], w_uk)
    return q_lat, q_rope, c, kr


def _out(ap, m, o_lat, prec):
    """Each head's output from its latent one (..., H, R), projected."""
    H, r, vd = m["num_heads"], m["kv_lora_rank"], m["v_head_dim"]
    w_uv = plain.weight(ap["w_uv"], prec).view(r, H, vd)
    o = torch.einsum("...hk,khv->...hv", o_lat, w_uv)
    return plain.mm(o.reshape(*o.shape[:-2], H * vd), ap["wo"], prec)


def _ffn(lp, m, h, prec):
    if "moe" in lp:
        return _moe(lp["moe"], m, h, prec)
    f = lp["ffn"]
    return plain.swiglu(h, f["w_gate"], f["w_in"], f["w_out"], prec)


def consistent_steps(pos: torch.Tensor) -> torch.Tensor:
    """(T, R) bool: whether every step after t in its row writes a slot
    above t's, so that the final cache holds what step t attended to."""
    big = torch.iinfo(pos.dtype).max
    later = torch.full_like(pos, big)
    later[:-1] = torch.flip(torch.cummin(torch.flip(pos[1:], [0]), 0)
                            .values, [0])
    return pos < later


def sampled_steps(pos: torch.Tensor, per_row: int = STEPS_PER_ROW):
    """(steps, rows): in each row, up to ``per_row`` of its consistent
    steps, evenly spread over them, the last step among them."""
    ok = consistent_steps(pos)
    steps, rows = [], []
    for r in range(pos.shape[1]):
        cand = ok[:, r].nonzero()[:, 0]
        if cand.numel() > per_row:
            pick = torch.linspace(0, cand.numel() - 1, per_row,
                                  device=pos.device).round().long()
            cand = cand[pick]
        steps.append(cand)
        rows.append(torch.full_like(cand, r))
    return torch.cat(steps), torch.cat(rows)


def _attend_cache(m, q_lat, q_rope, c, kr, pos, rows, cache, scale):
    """Each token (n: its row and position) against its row's cache
    (c_kv, k_rope) up to its own position, its own slot's entry being (c,
    kr): o_lat (n, H, R)."""
    o_lat = torch.empty_like(q_lat)
    for r in rows.unique().tolist():
        sel = (rows == r).nonzero()[:, 0]
        p = pos[sel]
        S = int(p.max()) + 1
        ck = cache[0][r, :S].float()
        kk = cache[1][r, :S].float()
        s = (torch.einsum("nhk,sk->nhs", q_lat[sel], ck)
             + torch.einsum("nhd,sd->nhs", q_rope[sel], kk))
        own = ((q_lat[sel] * c[sel][:, None]).sum(-1)
               + (q_rope[sel] * kr[sel][:, None]).sum(-1))        # (n, H)
        j = torch.arange(len(sel), device=pos.device)
        s[j, :, p] = own
        s = s * scale
        s = s.masked_fill(torch.arange(S, device=pos.device)[None, None]
                          > p[:, None, None], float("-inf"))
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("nhs,sk->nhk", pr, ck)
        o += pr[j, :, p][..., None] * (c[sel] - ck[p])[:, None]
        o_lat[sel] = o
    return o_lat


def _attend_causal(q_lat, q_rope, c, kr, scale):
    """Steps t = 0..T-1 of every row (T, R, ...), each attending to its
    own entry and those of the steps before it: o_lat (T, R, H, R)."""
    T = q_lat.shape[0]
    s = (torch.einsum("trhk,wrk->rthw", q_lat, c)
         + torch.einsum("trhd,wrd->rthw", q_rope, kr)) * scale
    later = torch.ones((T, T), dtype=torch.bool,
                       device=c.device).triu(1)[None, :, None]
    pr = torch.softmax(s.masked_fill(later, float("-inf")), dim=-1)
    return torch.einsum("rthw,wrk->trhk", pr, c)


def replay(params, cfg: dict, pos: torch.Tensor, *, prec: str = "fp32",
           logits_at: Optional[torch.Tensor] = None,
           on_layer: Optional[Callable] = None, teacher=None
           ) -> Dict[str, torch.Tensor]:
    """The decode steps of a run, token 0 in every row: ``pos`` (T, R) the
    slot each step writes in each row. With ``teacher`` (the program's
    cache per layer as the run left it, ``program_cache_layers``) the
    sampled steps (module docstring) are run from it; ``on_layer(i,
    leaves)`` receives each layer's cache, (R, slots, width) per leaf in
    the program's order (c_kv, k_rope): the program's, with the sampled
    steps' entries recomputed (fp32; bf16 for the fp8 control, whose
    copies of all 16 layers are kept); the logits are the last step's, (1,
    R, V). Without it, pos must be each step's index (a forward of T
    tokens from position 0) and the logits are those of ``logits_at``
    (len, R, V)."""
    plain.no_tf32()
    m = _mc(cfg)
    T, R = pos.shape
    eps = m["norm_eps"]
    scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    layers = params["prefix"] + params["layers"]
    dev = pos.device
    if teacher is None:
        steps = torch.arange(T, device=dev)
        if not bool((pos == steps[:, None]).all()):
            raise ValueError("without a teacher the steps must write "
                             "slots 0..T-1")
        x = params["embed"][0].float().expand(T, R, -1).clone()
        for i, lp in enumerate(layers):
            h = plain.rmsnorm(x, lp["attn_norm"], eps)
            q_lat, q_rope, c, kr = _project(lp["attn"], m, h, pos, prec)
            o_lat = _attend_causal(q_lat, q_rope, c, kr, scale)
            x = x + _out(lp["attn"], m, o_lat, prec)
            h = plain.rmsnorm(x, lp["ffn_norm"], eps).reshape(T * R, -1)
            x = x + _ffn(lp, m, h, prec).reshape(T, R, -1)
            if on_layer is not None:
                on_layer(i, [c.transpose(0, 1), kr.transpose(0, 1)])
        if logits_at is None:
            logits_at = torch.tensor([T - 1], device=dev)
        h = plain.rmsnorm(x[logits_at], params["final_norm"], eps)
        return {"logits": plain.mm(h, params["lm_head"], prec)}
    if logits_at is not None and logits_at.tolist() != [T - 1]:
        raise ValueError("with a teacher only the last step's logits")
    steps, rows = sampled_steps(pos)
    p = pos[steps, rows]
    slots = int(pos.max()) + 1
    keep = torch.bfloat16 if prec == "fp8" else torch.float32
    x = params["embed"][0].float().expand(len(steps), -1).clone()
    for i, lp in enumerate(layers):
        h = plain.rmsnorm(x, lp["attn_norm"], eps)
        q_lat, q_rope, c, kr = _project(lp["attn"], m, h, p, prec)
        o_lat = _attend_cache(m, q_lat, q_rope, c, kr, p, rows, teacher[i],
                              scale)
        x = x + _out(lp["attn"], m, o_lat, prec)
        h = plain.rmsnorm(x, lp["ffn_norm"], eps)
        x = x + _ffn(lp, m, h, prec)
        if on_layer is not None:
            refs = []
            for t, new in zip(teacher[i], (c, kr)):
                ref = t[:, :slots].to(keep, copy=True)
                ref[rows, p] = new.to(keep)
                refs.append(ref)
            on_layer(i, refs)
            del refs
    last = steps == T - 1
    out = torch.empty((R, x.shape[-1]), device=dev)
    out[rows[last]] = x[last]
    h = plain.rmsnorm(out, params["final_norm"], eps)
    return {"logits": plain.mm(h, params["lm_head"], prec)[None]}


# ---------------------------------------------------------------------------
# Operations of one decode step
# ---------------------------------------------------------------------------

def decode_flops(cfg: dict, contexts) -> float:
    """The operations one decode step needs for rows whose contexts (cached
    tokens) are ``contexts``: every matrix product of the token's path at
    the published widths (the compressed queries, the latents, the new
    latent's keys and values up-projected once, the output), the dense
    layers, and in each MoE layer the router over all 256 experts, the
    experts held here that a token reaches, by expectation (top 8 x 8/256),
    and the shared expert; the head; and attention over each row's cached
    tokens and its own, (nope + rope) wide for the scores and v wide for
    the values, none of the cached latents up-projected."""
    m = _mc(cfg)
    d, H, V = m["d_model"], m["num_heads"], m["vocab_size"]
    r, nope, rp, vd = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                       m["qk_rope_head_dim"], m["v_head_dim"])
    ql, f, fd = m["q_lora_rank"], m["moe_d_ff"], m["d_ff"]
    E, Ea, K = m["num_experts"], m["router_experts"], m["top_k"]
    fs = f * m["num_shared_experts"]
    mla = 2 * (d * ql + ql * H * (nope + rp) + d * (r + rp)
               + r * H * (nope + vd) + H * vd * d)
    moe = 2 * (d * Ea + 3 * d * f * K * E / Ea + 3 * d * fs)
    dense = 2 * 3 * d * fd
    L, Ld = m["num_layers"], m["first_k_dense"]
    per_token = L * mla + Ld * dense + (L - Ld) * moe + 2 * d * V
    attn = sum(2 * L * H * (c + 1) * (nope + rp + vd) for c in contexts)
    return float(per_token * len(contexts) + attn)
