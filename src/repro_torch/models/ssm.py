"""Mamba-2 (SSD) language model of the port, the counterpart of
``repro.models.ssm.MambaLM``: attention-free, with a constant-size state.

Prefill runs the chunked SSD form (through the Hopper SSD kernel with
``cfg.use_pallas``), decode the O(1)-per-token recurrent form. Params are a
dict: ``embed`` (V, d), ``final_norm``, ``lm_head`` (d, V) unless the
embeddings are tied, and ``layers``, a list of ``{"norm", "mixer"}`` dicts
(the JAX tree stacks them; see ``repro_torch.models.convert``). The cache is
an ``SSDState`` of tensors stacked over layers, (L, B, H, P, N) and
(L, B, k-1, conv_dim), as in the JAX package; ``decode_step`` writes the
new states into it in place and returns it, holding the values that the JAX
package's functional step returns.

A layer's residual add is left to the next layer's norm, or the final norm,
which takes it in (``add_rms_norm``), as in the dense model. ``loss`` is
the next-token cross entropy; with ``cfg.remat`` each layer is
recomputed in the backward pass (``common.remat_residual``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import blocks
from repro_torch.models.common import (ModelConfig, add_rms_norm, dense_init,
                                       embed_lookup, is_dtensor, matmul,
                                       remat_residual, softmax_cross_entropy,
                                       stack_layers, unstack)


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
        return embed_lookup(params["embed"], tokens).to(
            self.cfg.activation_dtype)

    def _unembed(self, params, x, pending):
        cfg = self.cfg
        _, x = add_rms_norm(x, pending, params["final_norm"], cfg.norm_eps,
                            cfg.use_pallas)
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        return matmul(x, head.to(x.dtype))

    def _run(self, params, x, *, collect_state: bool):
        cfg = self.cfg
        states, y = [], None
        for lp in params["layers"]:
            x, y, state = remat_residual(cfg.remat, self._layer, lp, x, y)
            if collect_state:
                states.append(state)
        return x, y, states

    def _layer(self, lp, x, y):
        """(x, y) in and (x, y, state) out: the layer's input is x + y."""
        cfg = self.cfg
        x, r = add_rms_norm(x, y, lp["norm"], cfg.norm_eps, cfg.use_pallas)
        return (x,) + blocks.ssd_block_forward(lp["mixer"], cfg, r)

    def forward(self, params, tokens, positions=None):
        x = self._embed(params, tokens)
        x, y, _ = self._run(params, x, collect_state=False)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._unembed(params, x, y), aux

    def loss(self, params, tokens, labels, mask=None):
        logits, _ = self.forward(params, tokens)
        return softmax_cross_entropy(logits, labels, mask)

    def prefill(self, params, tokens, max_len=None):
        x = self._embed(params, tokens)
        x, y, states = self._run(params, x, collect_state=True)
        return self._unembed(params, x[:, -1:], y[:, -1:]), _stack(states)

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        one = blocks.init_ssd_state(self.cfg, batch, device=device)
        L = self.cfg.num_layers
        return blocks.SSDState(*(t[None].repeat((L,) + (1,) * t.ndim)
                                 for t in one))

    def decode_step(self, params, token, cache, pos):
        """token: (B,1) int; pos: (B,) (unused: the state carries the
        position). Writes the new states into ``cache`` in place; returns
        the logits and ``cache``."""
        cfg = self.cfg
        x = self._embed(params, token)
        y = None
        work = cache
        if is_dtensor(cache.ssm):
            # a placed state's layers are split over the data axes: each
            # rank steps its rows and heads of every layer instead
            from repro_torch.distributed import parallel
            work = blocks.SSDState(ssm=parallel.unsplit_layers(cache.ssm, 2),
                                   conv=parallel.unsplit_layers(cache.conv, 3))
        for lp, ssm, conv in zip(params["layers"], unstack(work.ssm),
                                 unstack(work.conv)):
            x, r = add_rms_norm(x, y, lp["norm"], cfg.norm_eps,
                                cfg.use_pallas)
            y, _ = blocks.ssd_block_forward(
                lp["mixer"], cfg, r, state=blocks.SSDState(ssm=ssm, conv=conv))
        if work is not cache:
            parallel.write_back(cache.ssm, work.ssm)
            parallel.write_back(cache.conv, work.conv)
        return self._unembed(params, x, y), cache


def _stack(states) -> blocks.SSDState:
    return blocks.SSDState(ssm=stack_layers([s.ssm for s in states]),
                           conv=stack_layers([s.conv for s in states]))
