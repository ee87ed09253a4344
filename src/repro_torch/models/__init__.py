from repro_torch.models.common import (ModelConfig, tree_clone, tree_map,
                                       tree_tensors)
from repro_torch.models.registry import build_model

__all__ = ["ModelConfig", "build_model", "tree_clone", "tree_map",
           "tree_tensors"]
