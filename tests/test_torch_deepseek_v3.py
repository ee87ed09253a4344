"""DeepSeek-V3's block on the port, at a small size on the CPU: compressed
queries (q-LoRA), 128-head-style latent decode (here 4 heads), the sigmoid
group-limited router with its correction bias and scale, and a chip's
share of the experts, against this file's plain fp32 equations of the
published model (arXiv:2412.19437; the up-projected form of MLA, which the
program's decode does not use).

The small model: d 64, 4 heads, q_lora 32, kv_lora 32, 32 routed experts
in 8 groups of 4, the top 4 within the best 2 groups, 8 of them held here,
1 shared, 3 layers (1 dense), fp32. Tolerances: the program's forward
against the plain equations at 2e-4 (the same sums in another order and
form: absorbed or up-projected, fused or apart); its decode steps through
the latent cache against its forward at 1e-3 (each step attends in the
latent space, the forward up-projects); the model through the kernels'
plain versions against the equations at 5e-4. The same model in bf16
misses the first of them (``test_bf16_misses_the_fp32_tolerance``).
"""
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import launch_counts
from repro_torch.kernels import mla_decode as mla
from repro_torch.models import build_model
from repro_torch.models import blocks
from repro_torch.models.common import PORT_FIELDS, ModelConfig

CFG = ModelConfig(
    name="deepseek-v3-small", arch_type="moe", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=96, vocab_size=128,
    num_experts=8, num_shared_experts=1, top_k=4, moe_d_ff=32,
    first_k_dense=1, use_mla=True, kv_lora_rank=32, q_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    router_scoring="sigmoid", n_group=8, topk_group=2,
    routed_scaling_factor=2.5, router_experts=32, dtype="float32",
    param_dtype="float32")
FORWARD_TOL = 2e-4
DECODE_TOL = 1e-3
PLAIN_KERNELS_TOL = 5e-4


def _params(cfg=CFG, seed=0):
    """The model's init, with its norms spread around 1 and the router's
    correction bias drawn, so that both act."""
    gen = torch.Generator().manual_seed(seed)
    p = build_model(cfg).init(gen)
    with torch.no_grad():
        for lp in p["prefix"] + p["layers"]:
            for t in (lp["attn_norm"], lp["ffn_norm"], lp["attn"]["q_norm"],
                      lp["attn"]["kv_norm"]):
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
            if "moe" in lp:
                b = lp["moe"]["e_score_correction_bias"]
                b.copy_(0.2 * torch.rand(b.shape, generator=gen) - 0.1)
    return p


# ---------------------------------------------------------------------------
# The plain equations
# ---------------------------------------------------------------------------

def _norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2).float() / d)
    ang = pos.float()[..., None] * freqs
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                      x1 * ang.sin() + x2 * ang.cos()], dim=-1)


def _swiglu(x, f):
    return (F.silu(x @ f["w_gate"]) * (x @ f["w_in"])) @ f["w_out"]


def _route(mp, cfg, x):
    """The published noaux_tc gate: (weights, experts) (N, K) over all
    ``router_experts``."""
    E, G = cfg.routed_experts, cfg.n_group
    s = torch.sigmoid(x @ mp["router"])
    b = s + mp["e_score_correction_bias"]
    best2 = b.view(-1, G, E // G).topk(2, dim=-1).values.sum(-1)
    groups = torch.sort(best2, dim=-1, descending=True,
                        stable=True).indices[:, :cfg.topk_group]
    kept = torch.zeros_like(best2, dtype=torch.bool).scatter(1, groups, True)
    b = b.masked_fill(~kept.repeat_interleave(E // G, dim=1), -math.inf)
    idx = torch.sort(b, dim=-1, descending=True, stable=True).indices
    idx = idx[:, :cfg.top_k]
    w = s.gather(1, idx)
    return w / w.sum(-1, keepdim=True) * cfg.routed_scaling_factor, idx


def _moe(mp, cfg, x, shared=True):
    """The held experts' part (experts 0..num_experts-1) and, with
    ``shared``, the shared expert."""
    w, idx = _route(mp, cfg, x)
    y = torch.zeros_like(x)
    for e in range(cfg.num_experts):
        hit = (idx == e).float() * w
        f = {k: mp[k][e] for k in ("w_gate", "w_in", "w_out")}
        y = y + hit.sum(-1, keepdim=True) * _swiglu(x, f)
    return y + _swiglu(x, mp["shared"]) if shared else y


def _mla(ap, cfg, h, pos):
    """Causal MLA over a sequence h (B, S, d), keys and values
    up-projected from every latent."""
    B, S, _ = h.shape
    H, nope, rp, vd = (cfg.num_heads, cfg.qk_nope_head_dim,
                       cfg.qk_rope_head_dim, cfg.v_head_dim)
    eps, theta = cfg.norm_eps, cfg.rope_theta
    q = (_norm(h @ ap["wq_a"], ap["q_norm"], eps) @ ap["wq_b"]).view(
        B, S, H, nope + rp)
    q_rope = _rope(q[..., nope:], pos[:, :, None], theta)
    ckv = h @ ap["w_dkv"]
    c = _norm(ckv[..., :cfg.kv_lora_rank], ap["kv_norm"], eps)
    kr = _rope(ckv[..., cfg.kv_lora_rank:], pos, theta)
    k = (c @ ap["w_uk"]).view(B, S, H, nope)
    v = (c @ ap["w_uv"]).view(B, S, H, vd)
    s = (torch.einsum("bshd,bthd->bhst", q[..., :nope], k)
         + torch.einsum("bshd,btd->bhst", q_rope, kr)) * (nope + rp) ** -0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -math.inf)
    o = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), v)
    return o.reshape(B, S, H * vd) @ ap["wo"]


def _reference(p, cfg, tokens):
    """The logits (B, S, V) of the whole sequence, in fp32."""
    B, S = tokens.shape
    pos = torch.arange(S)[None].expand(B, S)
    x = p["embed"][tokens].float()
    for lp in p["prefix"] + p["layers"]:
        x = x + _mla(lp["attn"], cfg, _norm(x, lp["attn_norm"],
                                             cfg.norm_eps), pos)
        h = _norm(x, lp["ffn_norm"], cfg.norm_eps)
        if "moe" in lp:
            x = x + _moe(lp["moe"], cfg, h.reshape(B * S, -1)).view(B, S, -1)
        else:
            x = x + _swiglu(h, lp["ffn"])
    return _norm(x, p["final_norm"], cfg.norm_eps) @ p["lm_head"]


def _tokens(B=2, S=12, seed=1):
    return torch.randint(0, CFG.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(seed))


def _close(got, want, tol):
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_forward_and_prefill_match_the_plain_equations():
    p, toks = _params(), _tokens()
    model = build_model(CFG)
    want = _reference(p, CFG, toks)
    logits, _ = model.forward(p, toks)
    _close(logits, want, FORWARD_TOL)
    last, _ = model.prefill(p, toks[:, :9], max_len=16)
    _close(last[:, 0], want[:, 8], FORWARD_TOL)
    _close(last[:, 0], logits[:, 8], FORWARD_TOL)


def test_decode_through_the_cache_matches_the_forward():
    """Three decode steps after a 9-token prefill, each attending in the
    latent space (``_mla_absorbed``), against the forward's logits."""
    p, toks = _params(), _tokens()
    model = build_model(CFG)
    logits, _ = model.forward(p, toks)
    _, cache = model.prefill(p, toks[:, :9], max_len=16)
    for t in range(9, 12):
        out, cache = model.decode_step(p, toks[:, t:t + 1], cache,
                                       torch.full((2,), t))
        _close(out[:, 0], logits[:, t], DECODE_TOL)


def test_kernels_plain_versions_match_the_plain_equations():
    """``use_pallas`` on CPU tensors: RMSNorm and the latent decode through
    the kernels' plain versions, forward and decode."""
    p, toks = _params(seed=2), _tokens(seed=3)
    model = build_model(CFG.replace(use_pallas=True))
    want = _reference(p, CFG, toks)
    logits, _ = model.forward(p, toks)
    _close(logits, want, PLAIN_KERNELS_TOL)
    _, cache = model.prefill(p, toks[:, :11], max_len=16)
    out, _ = model.decode_step(p, toks[:, 11:], cache, torch.full((2,), 11))
    _close(out[:, 0], want[:, 11], PLAIN_KERNELS_TOL)


def test_bf16_misses_the_fp32_tolerance():
    """The tolerances tell the configuration's precision from the one
    below it: the same weights run in bf16 miss the forward's 2e-4."""
    p, toks = _params(seed=4), _tokens(seed=5)
    want = _reference(p, CFG, toks)
    bf = CFG.replace(dtype="bfloat16", param_dtype="bfloat16")
    pb = _cast(p, torch.bfloat16)
    logits, _ = build_model(bf).forward(pb, toks)
    err = (logits.float() - want).abs().max()
    assert err > FORWARD_TOL * (1 + want.abs().max())


def _cast(tree, dtype):
    """Every weight in ``dtype``, the router's correction bias kept fp32."""
    if isinstance(tree, dict):
        return {k: (v if k == "e_score_correction_bias" else _cast(v, dtype))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def test_query_compression_params():
    ap = _params()["prefix"][0]["attn"]
    assert "wq" not in ap
    assert ap["wq_a"].shape == (64, 32) and ap["q_norm"].shape == (32,)
    assert ap["wq_b"].shape == (32, 4 * (16 + 8))
    mp = _params()["layers"][0]["moe"]
    assert mp["router"].shape == (64, 32) and mp["w_gate"].shape[0] == 8
    assert mp["e_score_correction_bias"].dtype == torch.float32


def test_port_fields_default_to_the_old_path():
    cfg = ModelConfig()
    assert {k: getattr(cfg, k) for k in PORT_FIELDS} == {
        "q_lora_rank": 0, "router_scoring": "softmax", "n_group": 1,
        "topk_group": 1, "routed_scaling_factor": 1.0, "router_experts": 0}
    assert cfg.replace(num_experts=6).routed_experts == 6
    assert CFG.routed_experts == 32


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------

def _hand_route(logits, bias, cfg=CFG):
    """``blocks._route_sigmoid`` on one token whose router logits are
    ``logits``: x is the first unit vector, the router's first row the
    logits."""
    E = len(logits)
    x = torch.zeros(1, 1, 4)
    x[0, 0, 0] = 1.0
    router = torch.zeros(4, E)
    router[0] = torch.tensor(logits)
    s, w, idx = blocks._route_sigmoid(x, router, torch.tensor(bias),
                                      cfg.replace(router_experts=E))
    return s[0, 0], w[0, 0], idx[0, 0]


def test_router_cuts_off_a_group():
    """Expert 0 has the best score, but its group's second best is low:
    the group's sum loses to groups 1 and 2, and expert 0 is not taken."""
    logits = [-4.0] * 32
    logits[0] = 3.0                  # group 0: 3.0 and -4
    logits[4:6] = [2.0, 2.0]         # group 1
    logits[8:10] = [1.5, 1.5]        # group 2
    s, w, idx = _hand_route(logits, [0.0] * 32)
    assert sorted(idx.tolist()) == [4, 5, 8, 9]
    assert 0 not in idx.tolist()
    torch.testing.assert_close(w.sum(), torch.tensor(2.5))


def test_router_bias_picks_but_does_not_weigh():
    """A bias lifts expert 12 into the top 4 over expert 9; its weight is
    its unbiased score's share (x 2.5), not its biased one's."""
    logits = [-4.0] * 32
    logits[4:8] = [2.0, 2.0, 2.0, -4.0]    # group 1
    logits[8:10] = [1.5, 1.0]              # group 2
    logits[12] = 0.5                       # group 3
    bias = [0.0] * 32
    s, w, idx = _hand_route(logits, bias)
    assert idx.tolist() == [4, 5, 6, 8]
    bias[12] = 1.5                         # group 3 now beats group 2
    s, w, idx = _hand_route(logits, bias)
    assert idx.tolist() == [12, 4, 5, 6]
    chosen = s[[12, 4, 5, 6]]
    torch.testing.assert_close(w, 2.5 * chosen / chosen.sum())


def test_router_ties_go_to_the_lower_index():
    """Equal scores everywhere: groups 0 and 1 are kept, experts 0-3 of
    them taken, in order."""
    s, w, idx = _hand_route([0.0] * 32, [0.0] * 32)
    assert idx.tolist() == [0, 1, 2, 3]
    torch.testing.assert_close(w, torch.full((4,), 2.5 / 4))


def test_router_matches_the_plain_gate():
    p, cfg = _params(seed=6), CFG
    mp = p["layers"][1]["moe"]
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(7))
    _, w, idx = blocks._route_sigmoid(x[None], mp["router"],
                                      mp["e_score_correction_bias"], cfg)
    w_ref, idx_ref = _route(mp, cfg, x)
    assert torch.equal(idx[0], idx_ref)
    _close(w[0], w_ref, 1e-6)


def test_softmax_router_refuses_groups_and_scale():
    cfg = CFG.replace(router_scoring="softmax", router_experts=0,
                      num_experts=8)
    p = {"router": torch.zeros(64, 8)}
    x = torch.zeros(1, 2, 64)
    for bad in (dict(n_group=2), dict(n_group=1, routed_scaling_factor=2.0)):
        with pytest.raises(NotImplementedError):
            blocks.route(p, cfg.replace(**bad), x)
    with pytest.raises(ValueError):
        blocks.route(p, cfg.replace(router_scoring="relu", n_group=1,
                                    routed_scaling_factor=1.0), x)


# ---------------------------------------------------------------------------
# A chip's share of the experts
# ---------------------------------------------------------------------------

def test_shares_add_up_to_the_uncut_layer():
    """The guide's share test: 32 experts over 4 chips of 8. Each share's
    layer (its 8 experts first, the router's columns and bias rotated by
    whole groups to match) routes over all 32 and gives its experts' part;
    the 4 parts, with the shared expert counted once, add up to the uncut
    layer's output, and to the plain equations'."""
    full = CFG.replace(num_experts=32, router_experts=0)
    mp = _params(full, seed=8)["layers"][1]["moe"]
    x = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(9))
    whole, _ = blocks.moe_forward_dense(mp, full, x)
    parts = torch.zeros_like(x)
    for k in range(4):
        perm = torch.roll(torch.arange(32), -8 * k)
        share = {"router": mp["router"][:, perm],
                 "e_score_correction_bias":
                     mp["e_score_correction_bias"][perm]}
        for n in ("w_gate", "w_in", "w_out"):
            share[n] = mp[n][8 * k:8 * k + 8]
        y, _ = blocks.moe_forward_dense(share, CFG, x)
        parts = parts + y
    shared = blocks.ffn_forward(mp["shared"], CFG, x)
    _close(parts + shared, whole, 1e-5)
    _close(whole.reshape(10, -1), _moe(mp, full, x.reshape(10, -1)), 1e-5)


def test_a_share_holds_only_its_experts():
    """The held layer's output is the plain equations' part of experts 0-7
    plus the shared expert; the capacity dispatch refuses a share."""
    mp = _params(seed=10)["layers"][0]["moe"]
    x = torch.randn(3, 4, 64, generator=torch.Generator().manual_seed(11))
    y, aux = blocks.moe_forward_dense(mp, CFG, x)
    _close(y.reshape(12, -1), _moe(mp, CFG, x.reshape(12, -1)), 1e-5)
    assert torch.isfinite(aux.load_balance_loss)
    with pytest.raises(NotImplementedError):
        blocks.moe_forward_capacity(mp, CFG.replace(moe_dispatch="capacity"),
                                    x)


# ---------------------------------------------------------------------------
# The wide latent decode
# ---------------------------------------------------------------------------

def test_wide_heads_take_the_wide_kernel(monkeypatch):
    """Past 16 heads ``_mla_absorbed`` calls ``mla_decode_wide`` (on the
    CPU its plain version, which counts no launch); at 16 and below the
    narrow one."""
    from repro_torch.kernels import ops
    calls = []
    for name in ("mla_decode", "mla_decode_wide"):
        fn = getattr(ops, name)
        monkeypatch.setattr(
            ops, name, lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a))
    for H, want in ((16, "mla_decode"), (32, "mla_decode_wide")):
        cfg = CFG.replace(num_heads=H, num_kv_heads=H, use_pallas=True)
        p = _params(cfg, seed=12)
        toks = _tokens(seed=13)
        before = launch_counts()
        model = build_model(cfg)
        _, cache = model.prefill(p, toks[:, :9], max_len=16)
        out, _ = model.decode_step(p, toks[:, 9:10], cache,
                                   torch.full((2,), 9))
        assert calls[-1] == want and set(calls) == {want}
        assert launch_counts() == before
        logits, _ = build_model(cfg.replace(use_pallas=False)).forward(
            p, toks[:, :10])
        _close(out[:, 0], logits[:, 9], DECODE_TOL)
        calls.clear()


def test_wide_wrapper_on_the_cpu():
    """The plain version on CPU tensors, the operand checks on every
    device, no gradient; the grid plan: two runs an SM over the head
    groups, more where a run would take over 256 tiles."""
    g = torch.Generator().manual_seed(14)
    q = torch.randn(2, 40, 576, generator=g)
    c_kv = torch.randn(2, 30, 512, generator=g)
    k_rope = torch.randn(2, 30, 64, generator=g)
    valid = torch.arange(30)[None] < torch.tensor([[7], [30]])
    got = mla.mla_decode_wide(q, c_kv, k_rope, valid, 0.1)
    assert torch.equal(got, mla.mla_decode_plain(q, c_kv, k_rope, valid, 0.1))
    with pytest.raises(ValueError):
        mla.mla_decode_wide(q, c_kv, k_rope[:, :, :8][:, :29], valid, 0.1)
    with pytest.raises(RuntimeError):
        mla.mla_decode_wide(q.requires_grad_(), c_kv, k_rope, valid, 0.1)
    assert mla.grid_plan_wide(64, 16384, 128, 132) == 64 * 1024 // 256
    assert mla.grid_plan_wide(4, 520, 128, 132) == 132
    assert mla.grid_plan_wide(4, 520, 64, 132) == 264
    assert mla.grid_plan_wide(4, 520, 100, 132) == 132
