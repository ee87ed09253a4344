from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build_model

__all__ = ["ModelConfig", "build_model"]
