"""Dense decoder-only transformer of the port, the counterpart of
``repro.models.transformer.DecoderOnlyLM`` for the dense family. The MoE
and MLA variants raise ``NotImplementedError`` until they are ported.

Model contract (the JAX package's, with tensors for pytrees):
    init(gen)                                -> params
    forward(params, tokens)                  -> (logits (B,S,V), aux)
    prefill(params, tokens, max_len)         -> (logits (B,1,V), cache)
    init_cache(batch, max_len, device)       -> cache (zeros)
    decode_step(params, token, cache, pos)   -> (logits (B,1,V), cache)

Params are a dict: ``embed`` (V, d), ``final_norm``, ``lm_head`` (d, V),
``prefix`` (an empty list for the dense family) and ``layers``, a list of
per-layer dicts (the JAX tree stacks them on a leading axis; see
``repro_torch.models.convert``). The cache is ``{"prefix": [], "scanned":
KVCache}`` with (L, B, T, Hkv, D) tensors, and ``decode_step`` updates it in
place: it writes each layer's new K/V into the cache it was given and
returns that same cache.

The rope tables and, in a decode step, the cache slots written and read
are built once a forward or step and shared by every layer.

A layer leaves its last residual add to the norm after it: it returns
``(x, pending)``, its output being ``x + pending``, and the next layer's
first norm, or the final norm, takes the add in (``add_rms_norm``: one
kernel launch with ``use_pallas``). The plain path performs the same adds
and norms in the same order as a layer that sums its own output.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.common import (ModelConfig, add_rms_norm, dense_init,
                                       model_rope)


class DecoderOnlyLM:
    """Dense decoder LM."""

    def __init__(self, cfg: ModelConfig):
        if cfg.num_experts:
            raise NotImplementedError(f"{cfg.name}: MoE is not ported yet")
        if cfg.use_mla:
            raise NotImplementedError(f"{cfg.name}: MLA is not ported yet")
        self.cfg = cfg

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _init_layer(self, gen: torch.Generator):
        cfg = self.cfg
        ones = torch.ones((cfg.d_model,), dtype=cfg.weight_dtype,
                          device=gen.device)
        return {"attn_norm": ones, "ffn_norm": ones.clone(),
                "attn": attn.init_attention(gen, cfg),
                "ffn": blocks.init_ffn(gen, cfg)}

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
        params["prefix"] = []
        params["layers"] = [self._init_layer(gen)
                            for _ in range(cfg.num_layers)]
        return params

    # ------------------------------------------------------------------
    # layer bodies
    # ------------------------------------------------------------------
    def _layer_full(self, lp, x, pending, rope, cache_len=None):
        """(x, pending) in and out: the layer's input is x + pending."""
        cfg = self.cfg
        x, h = add_rms_norm(x, pending, lp["attn_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        a, cache = attn.attention_forward(
            lp["attn"], cfg, h, rope, window=cfg.attention_window,
            cache_len=cache_len)
        x, h = add_rms_norm(x, a, lp["ffn_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        return x, blocks.ffn_forward(lp["ffn"], cfg, h), cache

    def _layer_decode(self, lp, x, pending, cache, slots, rope):
        cfg = self.cfg
        x, h = add_rms_norm(x, pending, lp["attn_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        a, cache = attn.attention_decode(lp["attn"], cfg, h, cache, slots,
                                         rope)
        x, h = add_rms_norm(x, a, lp["ffn_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        return x, blocks.ffn_forward(lp["ffn"], cfg, h), cache

    # ------------------------------------------------------------------
    # public api
    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        return params["embed"][tokens].to(self.cfg.activation_dtype)

    def _unembed(self, params, x, pending):
        cfg = self.cfg
        _, x = add_rms_norm(x, pending, params["final_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        return x @ head.to(x.dtype)

    def _run_stack(self, params, x, positions, *, collect_cache: bool,
                   cache_len=None):
        caches, pending = [], None
        rope = model_rope(self.cfg, positions)
        for lp in params["layers"]:
            x, pending, c = self._layer_full(lp, x, pending, rope,
                                             cache_len=cache_len)
            if collect_cache:
                caches.append(c)
        return x, pending, caches

    def forward(self, params, tokens,
                positions: Optional[torch.Tensor] = None):
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device)[None].expand(
                B, S)
        x = self._embed(params, tokens)
        x, pending, _ = self._run_stack(params, x, positions,
                                        collect_cache=False)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._unembed(params, x, pending), aux

    def prefill(self, params, tokens, max_len=None):
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x = self._embed(params, tokens)
        x, pending, caches = self._run_stack(
            params, x, positions, collect_cache=True, cache_len=max_len)
        logits = self._unembed(params, x[:, -1:], pending[:, -1:])
        stacked = attn.KVCache(k=torch.stack([c.k for c in caches]),
                               v=torch.stack([c.v for c in caches]))
        return logits, {"prefix": [], "scanned": stacked}

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        """Zero caches for all layers, stacked: (L, B, T, Hkv, D)."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, cfg.attention_window or max_len,
                 cfg.num_kv_heads, cfg.head_dim)
        return {"prefix": [], "scanned": attn.KVCache(
            k=torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.activation_dtype, device=device))}

    def decode_step(self, params, token, cache, pos):
        """token: (B,1) int; pos: (B,) tokens already in cache. Writes the
        new K/V into ``cache`` in place and returns it."""
        x = self._embed(params, token)
        stacked, pending = cache["scanned"], None
        slots = attn.decode_slots(self.cfg, stacked.k.shape[2], pos)
        rope = model_rope(self.cfg, pos[:, None])
        for i, lp in enumerate(params["layers"]):
            x, pending, _ = self._layer_decode(
                lp, x, pending, attn.KVCache(k=stacked.k[i], v=stacked.v[i]),
                slots, rope)
        logits = self._unembed(params, x, pending)
        return logits, cache
