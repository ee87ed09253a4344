"""Mamba-2 (SSD) language model of the port, the counterpart of
``repro.models.ssm.MambaLM``: attention-free, with a constant-size state.

Prefill runs the chunked SSD form (through the Hopper SSD kernel with
``cfg.use_pallas``), decode the O(1)-per-token recurrent form. Params are a
dict: ``embed`` (V, d), ``final_norm``, ``lm_head`` (d, V) unless the
embeddings are tied, and ``layers``, a list of ``{"norm", "mixer"}`` dicts
(the JAX tree stacks them; see ``repro_torch.models.convert``). The cache is
an ``SSDState`` of tensors stacked over layers, (L, B, H, P, N) and
(L, B, k-1, conv_dim), as in the JAX package; ``decode_step`` returns a new
one.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import blocks
from repro_torch.models.common import ModelConfig, dense_init, rms_norm


class MambaLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.ssm_state <= 0:
            raise ValueError("ssm arch requires ssm_state")
        self.cfg = cfg

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
        params["layers"] = [
            {"norm": torch.ones((cfg.d_model,), dtype=cfg.weight_dtype,
                                device=gen.device),
             "mixer": blocks.init_ssd_block(gen, cfg)}
            for _ in range(cfg.num_layers)]
        return params

    def _embed(self, params, tokens):
        return params["embed"][tokens].to(self.cfg.activation_dtype)

    def _unembed(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.use_pallas)
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        return x @ head.to(x.dtype)

    def _run(self, params, x, *, collect_state: bool):
        cfg = self.cfg
        states = []
        for lp in params["layers"]:
            r = rms_norm(x, lp["norm"], cfg.norm_eps, cfg.use_pallas)
            y, state = blocks.ssd_block_forward(lp["mixer"], cfg, r)
            x = x + y
            if collect_state:
                states.append(state)
        return x, states

    def forward(self, params, tokens, positions=None):
        x = self._embed(params, tokens)
        x, _ = self._run(params, x, collect_state=False)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._unembed(params, x), aux

    def prefill(self, params, tokens, max_len=None):
        x = self._embed(params, tokens)
        x, states = self._run(params, x, collect_state=True)
        return self._unembed(params, x[:, -1:]), _stack(states)

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        one = blocks.init_ssd_state(self.cfg, batch, device=device)
        L = self.cfg.num_layers
        return blocks.SSDState(*(t[None].repeat((L,) + (1,) * t.ndim)
                                 for t in one))

    def decode_step(self, params, token, cache, pos):
        """token: (B,1) int; pos: (B,) (unused: the state carries the
        position). Returns the logits and a new cache."""
        cfg = self.cfg
        x = self._embed(params, token)
        states = []
        for i, lp in enumerate(params["layers"]):
            r = rms_norm(x, lp["norm"], cfg.norm_eps, cfg.use_pallas)
            y, st = blocks.ssd_block_forward(
                lp["mixer"], cfg, r,
                state=blocks.SSDState(ssm=cache.ssm[i], conv=cache.conv[i]))
            x = x + y
            states.append(st)
        return self._unembed(params, x), _stack(states)


def _stack(states) -> blocks.SSDState:
    return blocks.SSDState(ssm=torch.stack([s.ssm for s in states]),
                           conv=torch.stack([s.conv for s in states]))
