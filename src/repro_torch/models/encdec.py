"""Whisper-style encoder-decoder of the port, the counterpart of
``repro.models.encdec.EncDecLM``. [arXiv:2212.04356]

The mel-spectrogram and conv feature extractor is a stub, as in the JAX
package: ``encode``, ``forward`` and ``prefill`` take precomputed frame
embeddings (B, encoder_seq, d_model). Everything downstream (the
bidirectional encoder, the causal decoder with self- and cross-attention)
is real. Whisper uses LayerNorm with bias (at its default eps of 1e-5, not
``cfg.norm_eps``) and GELU MLPs; its positions are fixed sinusoids, so no
layer takes rope.

Model contract (the port's other models', with the frames beside the
tokens):
    init(gen)                                   -> params
    encode(params, frames)                      -> encoder states (B,T,d)
    forward(params, tokens, frames)             -> (logits (B,S,V), 0)
    loss(params, tokens, labels, frames, mask=None) -> scalar (training)
    prefill(params, tokens, frames, max_len)    -> (logits (B,1,V), cache)
    init_cache(batch, max_len, device)          -> cache (zeros)
    decode_step(params, token, cache, pos)      -> (logits (B,1,V), cache)

Params are a dict: ``embed`` (V, d), ``lm_head`` (d, V), the final norms
``enc_final_norm`` and ``dec_final_norm``, and the per-layer lists
``enc_layers`` and ``dec_layers`` (the JAX tree stacks them; see
``repro_torch.models.convert``). Every norm is ``{"w", "b"}``. The cache is
``{"self": KVCache of (L, B, max_len, Hkv, D) tensors, "cross_k",
"cross_v": (L, B, encoder_seq, Hkv, D)}``; ``decode_step`` writes the self
cache in place and returns the cache it was given, and only reads the cross
tensors.

Which attention runs where, as in the JAX package: the decoder's causal
self-attention goes through ``attention_forward`` and ``attention_decode``,
so with ``cfg.use_pallas`` it runs the flash-prefill and decode kernels;
the encoder's bidirectional attention and the cross-attention run the plain
``gqa_attention`` (fp32 einsums) with or without it.

With ``cfg.remat``, a forward that autograd records recomputes each
encoder and decoder layer in the backward pass (``common.remat``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.common import (ModelConfig, dense_init, embed_lookup,
                                       layer_norm, matmul, merge_dims, remat,
                                       sinusoidal_positions, sinusoids,
                                       softmax_cross_entropy, stack_layers,
                                       unstack)


def _ln(x, p):
    return layer_norm(x, p["w"], p["b"])


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        # the self-attention of both stacks takes no rope
        self.self_cfg = cfg.replace(use_rope=False)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _init_ln(self, gen: torch.Generator):
        cfg = self.cfg
        kw = dict(dtype=cfg.weight_dtype, device=gen.device)
        return {"w": torch.ones((cfg.d_model,), **kw),
                "b": torch.zeros((cfg.d_model,), **kw)}

    def _init_enc_layer(self, gen: torch.Generator):
        return {"attn_norm": self._init_ln(gen),
                "ffn_norm": self._init_ln(gen),
                "attn": attn.init_attention(gen, self.cfg),
                "ffn": blocks.init_ffn(gen, self.cfg)}

    def _init_dec_layer(self, gen: torch.Generator):
        return {"self_norm": self._init_ln(gen),
                "cross_norm": self._init_ln(gen),
                "ffn_norm": self._init_ln(gen),
                "self_attn": attn.init_attention(gen, self.cfg),
                "cross_attn": attn.init_cross_attention(gen, self.cfg),
                "ffn": blocks.init_ffn(gen, self.cfg)}

    def init(self, gen: torch.Generator) -> Any:
        """Random params drawn from ``gen``, on the generator's device."""
        cfg = self.cfg
        return {
            "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                cfg.weight_dtype, scale=0.02),
            "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                  cfg.weight_dtype),
            "enc_final_norm": self._init_ln(gen),
            "dec_final_norm": self._init_ln(gen),
            "enc_layers": [self._init_enc_layer(gen)
                           for _ in range(cfg.encoder_layers)],
            "dec_layers": [self._init_dec_layer(gen)
                           for _ in range(cfg.num_layers)],
        }

    # ------------------------------------------------------------------
    # encoder
    # ------------------------------------------------------------------
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T_enc, d_model), the stubbed frontend's output. A
        caller that wants no graph (serving) calls it under
        ``torch.no_grad()`` or with params that require no grad: at
        whisper-medium's 1500 frames a layer's fp32 scores are 1.15 GB at
        batch 8."""
        cfg = self.cfg
        T = frames.shape[1]
        x = frames + sinusoidal_positions(
            T, cfg.d_model, frames.device).to(frames.dtype)[None]
        for lp in params["enc_layers"]:
            x = remat(cfg.remat, self._enc_layer, lp, x)
        return _ln(x, params["enc_final_norm"])

    def _enc_layer(self, lp, x):
        cfg = self.cfg
        B, T, _ = x.shape
        a = _ln(x, lp["attn_norm"])
        q, k, v = attn._project_qkv(lp["attn"], self.self_cfg, a,
                                    cfg.num_kv_heads)
        y = merge_dims(attn.gqa_attention(q, k, v, None), 2)
        x = x + matmul(y, lp["attn"]["wo"].to(y.dtype))
        return x + blocks.ffn_forward(lp["ffn"], cfg, _ln(x, lp["ffn_norm"]))

    def _cross_kv(self, params, enc_out):
        """Each decoder layer's cross K and V of the encoder states, stacked:
        (L, B, T_enc, Hkv, D) each."""
        ks, vs = zip(*(attn.encoder_kv(lp["cross_attn"], self.cfg, enc_out)
                       for lp in params["dec_layers"]))
        return stack_layers(ks), stack_layers(vs)

    # ------------------------------------------------------------------
    # decoder
    # ------------------------------------------------------------------
    def _dec_layer_full(self, lp, x, enc_k, enc_v, cache_len=None):
        cfg = self.cfg
        y, cache = attn.attention_forward(
            lp["self_attn"], self.self_cfg, _ln(x, lp["self_norm"]), None,
            window=cfg.attention_window, cache_len=cache_len)
        x = x + y
        x = x + attn.cross_attention(lp["cross_attn"], cfg,
                                     _ln(x, lp["cross_norm"]), enc_k, enc_v)
        x = x + blocks.ffn_forward(lp["ffn"], cfg, _ln(x, lp["ffn_norm"]))
        return x, cache

    def _dec_layer_decode(self, lp, x, self_cache, enc_k, enc_v, slots):
        cfg = self.cfg
        y, _ = attn.attention_decode(lp["self_attn"], self.self_cfg,
                                     _ln(x, lp["self_norm"]), self_cache,
                                     slots, None)
        x = x + y
        x = x + attn.cross_attention(lp["cross_attn"], cfg,
                                     _ln(x, lp["cross_norm"]), enc_k, enc_v)
        return x + blocks.ffn_forward(lp["ffn"], cfg, _ln(x, lp["ffn_norm"]))

    def _embed_tokens(self, params, tokens, start_pos: int = 0):
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens).to(cfg.activation_dtype)
        S = tokens.shape[1]
        pos = sinusoidal_positions(start_pos + S, cfg.d_model,
                                   tokens.device)[start_pos:]
        return x + pos[None].to(x.dtype)

    def _unembed(self, params, x):
        x = _ln(x, params["dec_final_norm"])
        return matmul(x, params["lm_head"].to(x.dtype))

    def _run_decoder(self, params, tokens, frames, cache_len=None):
        """(decoder output (B,S,d), the self caches per layer, cross_k,
        cross_v)."""
        cross_k, cross_v = self._cross_kv(params,
                                          self.encode(params, frames))
        x = self._embed_tokens(params, tokens)
        caches = []
        for lp, ek, ev in zip(params["dec_layers"], unstack(cross_k),
                              unstack(cross_v)):
            x, c = remat(self.cfg.remat, self._dec_layer_full, lp, x, ek, ev,
                         cache_len)
            caches.append(c)
        return x, caches, cross_k, cross_v

    # ------------------------------------------------------------------
    # public api
    # ------------------------------------------------------------------
    def forward(self, params, tokens, frames):
        """Teacher-forced forward. tokens (B,S); frames (B,T,d)."""
        x, _, _, _ = self._run_decoder(params, tokens, frames)
        return (self._unembed(params, x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def loss(self, params, tokens, labels, frames, mask=None):
        """The next-token cross entropy of the teacher-forced forward; its
        gradient reaches the encoder through the cross K/V."""
        logits, _ = self.forward(params, tokens, frames)
        return softmax_cross_entropy(logits, labels, mask)

    def prefill(self, params, tokens, frames, max_len=None):
        x, caches, cross_k, cross_v = self._run_decoder(params, tokens,
                                                        frames, max_len)
        logits = self._unembed(params, x[:, -1:])
        stacked = attn.KVCache(*(stack_layers(t) for t in zip(*caches)))
        return logits, {"self": stacked, "cross_k": cross_k,
                        "cross_v": cross_v}

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        cfg = self.cfg
        L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        dt = dict(dtype=cfg.activation_dtype, device=device)
        kv = (L, batch, cfg.attention_window or max_len, Hkv, D)
        cross = (L, batch, cfg.encoder_seq, Hkv, D)
        return {"self": attn.KVCache(torch.zeros(kv, **dt),
                                     torch.zeros(kv, **dt)),
                "cross_k": torch.zeros(cross, **dt),
                "cross_v": torch.zeros(cross, **dt)}

    def decode_step(self, params, token, cache, pos):
        """token: (B,1) int; pos: (B,) tokens already in the cache. Writes
        the new self-attention entries into ``cache`` in place and returns
        it. Each row's sinusoid is computed from ``pos`` on the device."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], token).to(cfg.activation_dtype)
        x = x + sinusoids(pos, cfg.d_model)[:, None, :].to(x.dtype)
        self_c = cache["self"]
        slots = attn.decode_slots(cfg, self_c.k.shape[2], pos)
        for lp, k, v, ek, ev in zip(
                params["dec_layers"], unstack(self_c.k), unstack(self_c.v),
                unstack(cache["cross_k"]), unstack(cache["cross_v"])):
            x = self._dec_layer_decode(lp, x, attn.KVCache(k, v), ek, ev,
                                       slots)
        return self._unembed(params, x), cache
