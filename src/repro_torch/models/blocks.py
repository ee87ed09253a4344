"""Dense FFN block (gated and ungated). The MoE, RG-LRU and SSD blocks of
``repro.models.blocks`` are not ported yet."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import ModelConfig, dense_init, ffn_act, is_gated


def init_ffn(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None):
    d_ff = d_ff or cfg.d_ff
    dt = cfg.weight_dtype
    p = {"w_in": dense_init(gen, (cfg.d_model, d_ff), dt),
         "w_out": dense_init(gen, (d_ff, cfg.d_model), dt)}
    if is_gated(cfg.ffn_activation):
        p["w_gate"] = dense_init(gen, (cfg.d_model, d_ff), dt)
    return p


def ffn_forward(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_in"].to(x.dtype)
    if is_gated(cfg.ffn_activation):
        gate = x @ p["w_gate"].to(x.dtype)
        h = ffn_act(gate, up, cfg.ffn_activation)
    else:
        h = ffn_act(up, up, cfg.ffn_activation)
    return h @ p["w_out"].to(x.dtype)
