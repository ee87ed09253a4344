"""Architecture registry of the port: ``get_config(<arch id>)`` resolves the
same 11 configs as ``repro.configs``, built on the port's ``ModelConfig``,
and ``config_for_shape`` the variant an input shape
(``repro_torch.configs.shapes``) requires."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig
from repro_torch.configs.shapes import (SHAPES, InputShape,
                                        get_shape)

_MODULES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "chameleon-34b": "chameleon_34b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "nemotron-4-15b": "nemotron_4_15b",
    "whisper-medium": "whisper_medium",
    "mamba2-1.3b": "mamba2_1p3b",
    "starcoder2-7b": "starcoder2_7b",
    "tinyllama-1.1b": "tinyllama_1p1b",
    "phi3-medium-14b": "phi3_medium_14b",
    "llama3-3b": "llama3_3b",   # the paper's own eval model
}

# default sliding window used when long_500k forces a sub-quadratic variant
DEFAULT_LONG_WINDOW = 8192

ASSIGNED_ARCHS: List[str] = [k for k in _MODULES if k != "llama3-3b"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def long_context_window(arch: str) -> int:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return getattr(mod, "LONG_CONTEXT_WINDOW", DEFAULT_LONG_WINDOW)


def config_for_shape(arch: str, shape_name: str) -> ModelConfig:
    """Resolve the config variant an input shape requires (e.g. long_500k
    switches full-attention archs to their sliding-window variant)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if (shape.requires_subquadratic and cfg.arch_type
            not in ("ssm", "hybrid") and not cfg.attention_window):
        cfg = cfg.replace(attention_window=long_context_window(arch))
    return cfg


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in _MODULES}


__all__ = ["ASSIGNED_ARCHS", "DEFAULT_LONG_WINDOW", "SHAPES", "InputShape",
           "ModelConfig", "all_configs", "config_for_shape", "get_config",
           "get_shape", "long_context_window"]
