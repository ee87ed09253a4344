"""Analytical per-iteration FLOP/byte costs for a model config.

Used by the simulated execution backend (engine iterations) and cross-checked
against the XLA-compiled cost_analysis in the roofline benchmarks.

The config-dependent terms (parameter counts, attention-layer fraction,
KV bytes/token) are pure functions of the frozen ``ModelConfig``, so
:class:`CostModel` hoists them out of the per-iteration path once and the
remaining per-call work is a handful of fused multiply-adds. The module-level
``iteration_cost`` keeps the original functional API on top of a cached
``CostModel`` per config.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from repro_torch.models.common import ModelConfig


def param_count(cfg: ModelConfig) -> float:
    """Total parameters (approximate, matmul weights dominate)."""
    d = cfg.d_model
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0.0
    if cfg.arch_type == "ssm":
        conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        per_layer = (d * (2 * cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
                          + cfg.ssm_nheads)
                     + cfg.conv_kernel * conv_dim + cfg.d_inner * d)
        return emb + cfg.num_layers * per_layer
    # attention weights
    if cfg.use_mla:
        qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        attn_p = (d * cfg.num_heads * qk_dim
                  + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                  + cfg.kv_lora_rank * cfg.num_heads
                  * (cfg.qk_nope_head_dim + cfg.v_head_dim)
                  + cfg.num_heads * cfg.v_head_dim * d)
    else:
        attn_p = (d * cfg.num_heads * cfg.head_dim
                  + 2 * d * cfg.num_kv_heads * cfg.head_dim
                  + cfg.num_heads * cfg.head_dim * d)
    # ffn weights
    gate_mult = 3 if cfg.ffn_activation in ("swiglu", "geglu") else 2
    if cfg.num_experts:
        e_ff = cfg.moe_d_ff or cfg.d_ff
        ffn_p = cfg.num_experts * 3 * d * e_ff \
            + cfg.num_shared_experts * 3 * d * e_ff
        dense_ffn_p = gate_mult * d * cfg.d_ff
        n_moe = cfg.num_layers - cfg.first_k_dense
        total_layers = n_moe * (attn_p + ffn_p) \
            + cfg.first_k_dense * (attn_p + dense_ffn_p)
        return emb + total_layers
    if cfg.arch_type == "hybrid":
        rec_p = (2 * d * cfg.lru_width + 2 * cfg.lru_width ** 2
                 + cfg.lru_width * d)
        attn_frac = (cfg.block_pattern or ("rec", "rec", "attn")).count(
            "attn") / len(cfg.block_pattern or ("rec", "rec", "attn"))
        mix_p = attn_frac * attn_p + (1 - attn_frac) * rec_p
        per_layer = mix_p + gate_mult * d * cfg.d_ff
        return emb + cfg.num_layers * per_layer
    per_layer = attn_p + gate_mult * d * cfg.d_ff
    n_dec = cfg.num_layers
    total = emb + n_dec * per_layer
    if cfg.is_encoder_decoder:
        enc_layer = attn_p + gate_mult * d * cfg.d_ff
        cross_p = attn_p
        total += cfg.encoder_layers * enc_layer + n_dec * cross_p
    return total


def active_param_count(cfg: ModelConfig) -> float:
    """Parameters touched per token (MoE: only routed top-k + shared)."""
    if not cfg.num_experts:
        return param_count(cfg)
    d = cfg.d_model
    e_ff = cfg.moe_d_ff or cfg.d_ff
    dense = param_count(cfg.replace(num_experts=0, num_shared_experts=0,
                                    first_k_dense=0, d_ff=1))
    n_moe = cfg.num_layers - cfg.first_k_dense
    active_ffn = (cfg.top_k + cfg.num_shared_experts) * 3 * d * e_ff
    gate_mult = 3
    return (dense + n_moe * active_ffn
            + cfg.first_k_dense * gate_mult * d * cfg.d_ff)


def kv_bytes_per_token_layer(cfg: ModelConfig, bytes_per_el: int = 2) -> float:
    """KV-cache bytes appended per token per attention layer."""
    if cfg.use_mla:
        return (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * bytes_per_el
    return 2 * cfg.num_kv_heads * cfg.head_dim * bytes_per_el


def attention_layers(cfg: ModelConfig) -> float:
    if cfg.arch_type == "ssm":
        return 0.0
    if cfg.arch_type == "hybrid":
        pat = cfg.block_pattern or ("rec", "rec", "attn")
        return cfg.num_layers * pat.count("attn") / len(pat)
    return cfg.num_layers


class CostModel:
    """Per-``ModelConfig`` iteration-cost evaluator with every
    config-derived term precomputed once.

    ``iteration_cost`` here is arithmetic-identical (same expressions, same
    association order) to the historical module-level function, so simulated
    clocks/energies are bit-for-bit unchanged — it just stops re-deriving
    ``active_param_count``/``attention_layers``/``kv_bytes_per_token_layer``
    on every engine iteration.
    """

    def __init__(self, cfg: ModelConfig, bytes_per_el: int = 2):
        self.cfg = cfg
        self.bytes_per_el = bytes_per_el
        self.n_active = active_param_count(cfg)
        self.n_total = param_count(cfg)
        self.attn_layers = attention_layers(cfg)
        self.window = cfg.attention_window or 0
        # flops = _flops_per_token * tokens + _attn_coeff * ctx-terms
        self._flops_per_token = 2.0 * self.n_active
        self._attn_coeff = 4.0 * (cfg.num_heads * cfg.head_dim) \
            * self.attn_layers
        # memory: weights stream once per iteration, KV traffic per token
        self.kv_bytes_per_token = kv_bytes_per_token_layer(cfg, bytes_per_el) \
            * self.attn_layers
        self.weight_bytes = self.n_active * bytes_per_el
        if cfg.arch_type == "ssm":
            self._state_bytes_per_seq = (cfg.ssm_nheads * cfg.ssm_head_dim
                                         * cfg.ssm_state * 4) * cfg.num_layers
        elif cfg.arch_type == "hybrid":
            self._state_bytes_per_seq = (cfg.lru_width * 4) * cfg.num_layers
        else:
            self._state_bytes_per_seq = 0

    def iteration_cost(self, *, prefill_tokens: int, decode_seqs: int,
                       avg_context: float, cached_prefill_tokens: int = 0):
        """(flops, mem_bytes) for one continuous-batching iteration.

        prefill_tokens: NEW prompt tokens processed this iteration
        (prefix-cache hits excluded); decode_seqs: sequences generating one
        token each; avg_context: mean KV length the decode tokens attend to.
        """
        tokens = prefill_tokens + decode_seqs
        eff_ctx = min(avg_context, self.window) if self.window \
            else avg_context
        ctx = max(eff_ctx, 1.0)
        # attention score/value FLOPs: 4 * d_attn * context per token per
        # layer; prefill pays the causal triangle (factor 0.5)
        flops = self._flops_per_token * tokens + self._attn_coeff * (
            prefill_tokens * ctx * 0.5 + decode_seqs * ctx)
        kv = self.kv_bytes_per_token
        mem = self.weight_bytes                 # weight reads
        mem += tokens * kv                      # cache writes
        mem += decode_seqs * kv * ctx           # decode cache reads
        mem += prefill_tokens * kv * 0.1        # prefill reread (flash)
        if self._state_bytes_per_seq:           # ssm/recurrent state traffic
            mem += decode_seqs * self._state_bytes_per_seq
        return flops, mem

    def iteration_cost_vec(self, *, prefill_tokens: "np.ndarray",
                           decode_seqs: "np.ndarray",
                           avg_context: "np.ndarray"):
        """Vectorized :meth:`iteration_cost` over per-node arrays.

        Elementwise it is the identical expression sequence (same
        association order) as the scalar path, so the batched fleet backend
        gets bit-for-bit the scalar flops/bytes for every node at once."""
        tokens = prefill_tokens + decode_seqs
        if self.window:
            eff_ctx = np.minimum(avg_context, self.window)
        else:
            eff_ctx = avg_context
        ctx = np.maximum(eff_ctx, 1.0)
        flops = self._flops_per_token * tokens + self._attn_coeff * (
            prefill_tokens * ctx * 0.5 + decode_seqs * ctx)
        kv = self.kv_bytes_per_token
        mem = self.weight_bytes + tokens * kv
        mem = mem + decode_seqs * kv * ctx
        mem = mem + prefill_tokens * kv * 0.1
        if self._state_bytes_per_seq:
            mem = mem + decode_seqs * self._state_bytes_per_seq
        return flops, mem


@lru_cache(maxsize=256)
def get_cost_model(cfg: ModelConfig, bytes_per_el: int = 2) -> CostModel:
    """Shared ``CostModel`` per (config, dtype width) — configs are frozen
    dataclasses, so caching on identity-of-value is safe."""
    return CostModel(cfg, bytes_per_el)


def iteration_cost(cfg: ModelConfig, *, prefill_tokens: int,
                   decode_seqs: int, avg_context: float,
                   cached_prefill_tokens: int = 0,
                   bytes_per_el: int = 2):
    """Functional API over the cached :class:`CostModel` (see there)."""
    return get_cost_model(cfg, bytes_per_el).iteration_cost(
        prefill_tokens=prefill_tokens, decode_seqs=decode_seqs,
        avg_context=avg_context, cached_prefill_tokens=cached_prefill_tokens)
