"""Decoder-only transformer of the port, the counterpart of
``repro.models.transformer.DecoderOnlyLM``: the dense and MoE families,
with GQA or MLA (DeepSeek-V2) attention.

Model contract (the JAX package's, with tensors for pytrees):
    init(gen)                                -> params
    forward(params, tokens)                  -> (logits (B,S,V), aux)
    loss(params, tokens, labels, mask=None)  -> scalar (training)
    prefill(params, tokens, max_len)         -> (logits (B,1,V), cache)
    init_cache(batch, max_len, device)       -> cache (zeros)
    decode_step(params, token, cache, pos)   -> (logits (B,1,V), cache)

Params are a dict: ``embed`` (V, d), ``final_norm``, ``lm_head`` (d, V),
``prefix``, a list of the leading dense-FFN layers of an MoE model
(``first_k_dense``; empty otherwise), and ``layers``, a list of per-layer
dicts (the JAX tree stacks them on a leading axis; see
``repro_torch.models.convert``). A layer holds ``ffn``, or ``moe`` in the
layers of an MoE model past its prefix. ``aux`` is the sum of the MoE
layers' load-balance losses (0 for a dense model). The cache is
``{"prefix": [one per prefix layer], "scanned": stacked}``, each a
``KVCache`` of (B, T, Hkv, D) tensors, or under MLA an ``MLACache`` of the
(B, T, kv_lora_rank) latents and (B, T, qk_rope_head_dim) rope keys, and
``stacked`` the same with a leading layer axis. ``decode_step`` updates it
in place: it writes each layer's new entries into the cache it was given
and returns that same cache.

With ``cfg.remat``, a forward that autograd records recomputes each
layer's activations in the backward pass (``common.remat_residual``).

The rope tables and, in a decode step, the cache slots written and read
are built once a forward or step and shared by every layer.

A layer leaves its last residual add to the norm after it: it returns
``(x, pending, ...)``, its output being ``x + pending``, and the next
layer's first norm, or the final norm, takes the add in (``add_rms_norm``:
one kernel launch with ``use_pallas``). The plain path performs the same
adds and norms in the same order as a layer that sums its own output.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.common import (ModelConfig, add_rms_norm, dense_init,
                                       embed_lookup, matmul, model_rope,
                                       remat_residual, softmax_cross_entropy,
                                       stack_layers, unstack)


class DecoderOnlyLM:
    """Dense or MoE decoder LM, with GQA or MLA attention."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.n_prefix = cfg.first_k_dense if cfg.num_experts else 0
        self.n_scanned = cfg.num_layers - self.n_prefix

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _init_layer(self, gen: torch.Generator, *, moe: bool):
        cfg = self.cfg
        ones = torch.ones((cfg.d_model,), dtype=cfg.weight_dtype,
                          device=gen.device)
        p = {"attn_norm": ones, "ffn_norm": ones.clone(),
             "attn": (attn.init_mla(gen, cfg) if cfg.use_mla
                      else attn.init_attention(gen, cfg))}
        if moe:
            p["moe"] = blocks.init_moe(gen, cfg)
        else:
            p["ffn"] = blocks.init_ffn(gen, cfg)
        return p

    def init(self, gen: torch.Generator) -> Any:
        """Random params drawn from ``gen``, on the generator's device."""
        cfg = self.cfg
        params = {
            "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                cfg.weight_dtype, scale=0.02),
            "final_norm": torch.ones((cfg.d_model,), dtype=cfg.weight_dtype,
                                     device=gen.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(
                gen, (cfg.d_model, cfg.vocab_size), cfg.weight_dtype)
        params["prefix"] = [self._init_layer(gen, moe=False)
                            for _ in range(self.n_prefix)]
        moe = bool(cfg.num_experts)
        params["layers"] = [self._init_layer(gen, moe=moe)
                            for _ in range(self.n_scanned)]
        return params

    # ------------------------------------------------------------------
    # layer bodies
    # ------------------------------------------------------------------
    def _layer_full(self, lp, x, pending, rope, cache_len=None):
        """(x, pending) in; (x, pending, cache, the MoE load-balance loss or
        None) out: the layer's input is x + pending."""
        cfg = self.cfg
        x, h = add_rms_norm(x, pending, lp["attn_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        if cfg.use_mla:
            a, cache = attn.mla_forward(lp["attn"], cfg, h, rope,
                                        cache_len=cache_len)
        else:
            a, cache = attn.attention_forward(
                lp["attn"], cfg, h, rope, window=cfg.attention_window,
                cache_len=cache_len)
        x, h = add_rms_norm(x, a, lp["ffn_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        if "moe" in lp:
            f, aux = blocks.moe_forward(lp["moe"], cfg, h)
            return x, f, cache, aux.load_balance_loss
        return x, blocks.ffn_forward(lp["ffn"], cfg, h), cache, None

    def _layer_decode(self, lp, x, pending, cache, slots, rope):
        cfg = self.cfg
        x, h = add_rms_norm(x, pending, lp["attn_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        if cfg.use_mla:
            a, cache = attn.mla_decode(lp["attn"], cfg, h, cache, slots,
                                       rope)
        else:
            a, cache = attn.attention_decode(lp["attn"], cfg, h, cache,
                                             slots, rope)
        x, h = add_rms_norm(x, a, lp["ffn_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        if "moe" in lp:
            return x, blocks.moe_forward(lp["moe"], cfg, h)[0], cache
        return x, blocks.ffn_forward(lp["ffn"], cfg, h), cache

    # ------------------------------------------------------------------
    # public api
    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        return embed_lookup(params["embed"], tokens).to(
            self.cfg.activation_dtype)

    def _unembed(self, params, x, pending):
        cfg = self.cfg
        _, x = add_rms_norm(x, pending, params["final_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        return matmul(x, head.to(x.dtype))

    def _run_stack(self, params, x, positions, *, collect_cache: bool,
                   cache_len=None):
        """(x, pending, the summed load-balance loss or None, the prefix
        layers' caches, the other layers' caches)."""
        caches, pending, aux = [], None, None
        rope = model_rope(self.cfg, positions)
        for lp in params["prefix"] + params["layers"]:
            x, pending, c, a = remat_residual(
                self.cfg.remat, self._layer_full, lp, x, pending, rope,
                cache_len)
            if a is not None:
                aux = a if aux is None else aux + a
            if collect_cache:
                caches.append(c)
        return (x, pending, aux, caches[:self.n_prefix],
                caches[self.n_prefix:])

    def forward(self, params, tokens,
                positions: Optional[torch.Tensor] = None):
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device)[None].expand(
                B, S)
        x = self._embed(params, tokens)
        x, pending, aux, _, _ = self._run_stack(params, x, positions,
                                                collect_cache=False)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._unembed(params, x, pending), aux

    def loss(self, params, tokens, labels, mask=None):
        """The next-token cross entropy plus 0.01 x the MoE load-balance
        loss (0 for a dense model)."""
        logits, aux = self.forward(params, tokens)
        return softmax_cross_entropy(logits, labels, mask) + 0.01 * aux

    def prefill(self, params, tokens, max_len=None):
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x = self._embed(params, tokens)
        x, pending, _, prefix, caches = self._run_stack(
            params, x, positions, collect_cache=True, cache_len=max_len)
        logits = self._unembed(params, x[:, -1:], pending[:, -1:])
        stacked = type(caches[0])(*(stack_layers(t) for t in zip(*caches)))
        return logits, {"prefix": prefix, "scanned": stacked}

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        """Zero caches: one per prefix layer, and the other layers'
        stacked on a leading axis."""
        cfg = self.cfg
        if cfg.use_mla:
            cls, shapes = attn.MLACache, (
                (batch, max_len, cfg.kv_lora_rank),
                (batch, max_len, cfg.qk_rope_head_dim))
        else:
            kv = (batch, cfg.attention_window or max_len, cfg.num_kv_heads,
                  cfg.head_dim)
            cls, shapes = attn.KVCache, (kv, kv)

        def zeros(*lead):
            return cls(*(torch.zeros(lead + s, dtype=cfg.activation_dtype,
                                     device=device) for s in shapes))

        return {"prefix": [zeros() for _ in range(self.n_prefix)],
                "scanned": zeros(self.n_scanned)}

    def decode_step(self, params, token, cache, pos):
        """token: (B,1) int; pos: (B,) tokens already in cache. Writes the
        new entries into ``cache`` in place and returns it."""
        cfg = self.cfg
        x = self._embed(params, token)
        stacked, pending = cache["scanned"], None
        # MLA's cache is never a ring: the JAX package ignores a window there
        slots = attn.decode_slots(
            cfg.replace(attention_window=0) if cfg.use_mla else cfg,
            stacked[0].shape[2], pos)
        rope = model_rope(cfg, pos[:, None])
        layer_caches = cache["prefix"] + [
            type(stacked)(*layer)
            for layer in zip(*(unstack(t) for t in stacked))]
        for lp, c in zip(params["prefix"] + params["layers"], layer_caches):
            x, pending, _ = self._layer_decode(lp, x, pending, c, slots,
                                               rope)
        logits = self._unembed(params, x, pending)
        return logits, cache
