"""RecurrentGemma / Griffin hybrid of the port, the counterpart of
``repro.models.hybrid.HybridLM``: RG-LRU recurrent blocks and local (MQA,
windowed) attention at a 1:2 ratio.

Layer layout: units of (rec, rec, attn), then a trailing remainder of rec
layers (38 = 12 * 3 + 2). Every layer is a residual pair (temporal mixer,
GeGLU MLP) with pre-RMSNorm. Prefill attention is the plain banded path
(as in the JAX package); decode attention runs against a ring cache of
``local_window`` slots, through the Hopper decode kernel with
``cfg.use_pallas``.

Params are a dict: ``embed``, ``final_norm``, ``lm_head`` unless tied,
``units``, a list of ``{"l0", "l1", "l2"}`` dicts of layer dicts (the JAX
tree stacks them; see ``repro_torch.models.convert``), and ``tail``, a list
of layer dicts. The cache is ``{"units": [{"l0": RGLRUState, "l1":
RGLRUState, "l2": KVCache}, ...], "tail": [RGLRUState, ...]}``;
``decode_step`` writes each KV cache and recurrent state in place and
returns the cache it was given. The rope tables and the ring's slots are
built once a forward or step and shared by the attention layers.

A layer's last residual add is left to the next layer's first norm, or the
final norm, which takes it in (``add_rms_norm``), as in the dense model.
``loss`` is the next-token cross entropy; with ``cfg.remat`` each layer is
recomputed in the backward pass (``common.remat_residual``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.common import (ModelConfig, add_rms_norm, dense_init,
                                       embed_lookup, matmul, model_rope,
                                       remat_residual, softmax_cross_entropy)


class HybridLM:
    def __init__(self, cfg: ModelConfig):
        if not (cfg.lru_width and cfg.local_window):
            raise ValueError("hybrid arch requires lru_width and "
                             "local_window")
        self.cfg = cfg
        self.pattern = cfg.block_pattern or ("rec", "rec", "attn")
        self.n_units = cfg.num_layers // len(self.pattern)
        self.n_tail = cfg.num_layers - self.n_units * len(self.pattern)

    # ------------------------------------------------------------------
    def _init_layer(self, gen: torch.Generator, kind: str):
        cfg = self.cfg
        ones = torch.ones((cfg.d_model,), dtype=cfg.weight_dtype,
                          device=gen.device)
        mixer = (blocks.init_rglru_block(gen, cfg) if kind == "rec"
                 else attn.init_attention(gen, cfg, num_kv=cfg.num_kv_heads))
        return {"temporal_norm": ones, "mlp_norm": ones.clone(),
                "mixer": mixer, "mlp": blocks.init_ffn(gen, cfg)}

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
        params["units"] = [
            {f"l{i}": self._init_layer(gen, kind)
             for i, kind in enumerate(self.pattern)}
            for _ in range(self.n_units)]
        params["tail"] = [self._init_layer(gen, "rec")
                          for _ in range(self.n_tail)]
        return params

    # ------------------------------------------------------------------
    def _layer_full(self, lp, kind, x, pending, rope):
        """(x, pending) in and out: the layer's input is x + pending."""
        cfg = self.cfg
        x, h = add_rms_norm(x, pending, lp["temporal_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        if kind == "attn":
            y, cache = attn.attention_forward(lp["mixer"], cfg, h, rope,
                                              window=cfg.local_window)
        else:
            y, cache = blocks.rglru_block_forward(lp["mixer"], cfg, h)
        x, h = add_rms_norm(x, y, lp["mlp_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        return x, blocks.ffn_forward(lp["mlp"], cfg, h), cache

    def _layer_decode(self, lp, kind, x, pending, cache, slots, rope):
        """Writes the layer's cache in place and returns it as ``nc``."""
        cfg = self.cfg
        x, h = add_rms_norm(x, pending, lp["temporal_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        if kind == "attn":
            y, nc = attn.attention_decode(lp["mixer"], cfg, h, cache, slots,
                                          rope)
        else:
            y, nc = blocks.rglru_block_forward(lp["mixer"], cfg, h,
                                               state=cache)
        x, h = add_rms_norm(x, y, lp["mlp_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        return x, blocks.ffn_forward(lp["mlp"], cfg, h), nc

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

    def _run(self, params, x, positions):
        unit_caches, pending = [], None
        rope = model_rope(self.cfg, positions)
        for up in params["units"]:
            caches = {}
            for i, kind in enumerate(self.pattern):
                x, pending, caches[f"l{i}"] = remat_residual(
                    self.cfg.remat, self._layer_full, up[f"l{i}"], kind, x,
                    pending, rope)
            unit_caches.append(caches)
        tail_caches = []
        for lp in params["tail"]:
            x, pending, c = remat_residual(self.cfg.remat, self._layer_full,
                                           lp, "rec", x, pending, rope)
            tail_caches.append(c)
        return x, pending, {"units": unit_caches, "tail": tail_caches}

    def forward(self, params, tokens,
                positions: Optional[torch.Tensor] = None):
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device)[None].expand(
                B, S)
        x = self._embed(params, tokens)
        x, pending, _ = self._run(params, x, positions)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._unembed(params, x, pending), aux

    def loss(self, params, tokens, labels, mask=None):
        logits, _ = self.forward(params, tokens)
        return softmax_cross_entropy(logits, labels, mask)

    def prefill(self, params, tokens, max_len=None):
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x = self._embed(params, tokens)
        x, pending, caches = self._run(params, x, positions)
        return self._unembed(params, x[:, -1:], pending[:, -1:]), caches

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        """Zero states, and ring KV caches of ``local_window`` slots."""
        cfg = self.cfg

        def one(kind):
            if kind == "attn":
                return attn.init_kv_cache(
                    cfg.replace(attention_window=cfg.local_window), batch,
                    max_len, device=device)
            return blocks.init_rglru_state(cfg, batch, device=device)

        return {"units": [{f"l{i}": one(kind)
                           for i, kind in enumerate(self.pattern)}
                          for _ in range(self.n_units)],
                "tail": [one("rec") for _ in range(self.n_tail)]}

    def decode_step(self, params, token, cache, pos):
        """token: (B,1) int; pos: (B,) tokens already in cache. Writes the
        KV caches and recurrent states in place; returns the logits and
        ``cache``."""
        cfg = self.cfg
        x = self._embed(params, token)
        pending = None
        slots = attn.decode_slots(cfg, cfg.local_window, pos,
                                  window=cfg.local_window)
        rope = model_rope(self.cfg, pos[:, None])
        for up, uc in zip(params["units"], cache["units"]):
            for i, kind in enumerate(self.pattern):
                x, pending, _ = self._layer_decode(
                    up[f"l{i}"], kind, x, pending, uc[f"l{i}"], slots, rope)
        for lp, c in zip(params["tail"], cache["tail"]):
            x, pending, _ = self._layer_decode(lp, "rec", x, pending, c,
                                               slots, rope)
        return self._unembed(params, x, pending), cache
