"""The port's distribution layer: sharding specs of params, optimizer
state, caches and batches, and their DTensor placements
(``repro_torch.distributed.sharding``)."""
from repro_torch.distributed.sharding import (PSpec, batch_pspec,
                                              cache_pspecs, data_axes,
                                              logits_pspec, param_pspecs,
                                              sanitize_spec, to_placements,
                                              with_sharding)

__all__ = ["PSpec", "batch_pspec", "cache_pspecs", "data_axes",
           "logits_pspec", "param_pspecs", "sanitize_spec", "to_placements",
           "with_sharding"]
