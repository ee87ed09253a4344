"""Model factory: ModelConfig -> model object with the uniform contract.
The port has the dense decoder-only, SSM (Mamba-2) and hybrid
(RecurrentGemma) families; the encoder-decoder family of ``repro.models``
is not ported yet."""
from __future__ import annotations

from repro_torch.models.common import ModelConfig


def build_model(cfg: ModelConfig):
    if cfg.arch_type == "ssm":
        from repro_torch.models.ssm import MambaLM
        return MambaLM(cfg)
    if cfg.arch_type == "hybrid":
        from repro_torch.models.hybrid import HybridLM
        return HybridLM(cfg)
    if cfg.arch_type in ("encdec", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type} family is not ported yet")
    from repro_torch.models.transformer import DecoderOnlyLM
    return DecoderOnlyLM(cfg)
