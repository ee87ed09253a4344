"""Architecture registry of the port: ``get_config(<arch id>)`` resolves the
same 11 configs as ``repro.configs``, built on the port's ``ModelConfig``.
Input shapes (``repro.configs.shapes``) are not ported yet."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

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

ASSIGNED_ARCHS: List[str] = [k for k in _MODULES if k != "llama3-3b"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in _MODULES}


__all__ = ["ASSIGNED_ARCHS", "ModelConfig", "all_configs", "get_config"]
