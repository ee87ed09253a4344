"""Model factory: ModelConfig -> model object with the uniform contract.
The port has the dense decoder-only family so far; the SSM, hybrid and
encoder-decoder families of ``repro.models`` are not ported yet."""
from __future__ import annotations

from repro_torch.models.common import ModelConfig


def build_model(cfg: ModelConfig):
    if cfg.arch_type in ("ssm", "hybrid", "encdec", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type} family is not ported yet")
    from repro_torch.models.transformer import DecoderOnlyLM
    return DecoderOnlyLM(cfg)
