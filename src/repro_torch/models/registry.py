"""Model factory: ModelConfig -> model object with the uniform contract.
The port has every family of ``repro.models``: the dense and MoE
decoder-only (GQA or MLA attention), SSM (Mamba-2), hybrid
(RecurrentGemma) and encoder-decoder (Whisper) families."""
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
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg)
    from repro_torch.models.transformer import DecoderOnlyLM
    return DecoderOnlyLM(cfg)
