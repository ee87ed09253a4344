"""The port's configs match ``repro.configs`` field for field, full size and
reduced, for all 11 architectures; the port's own fields (``PORT_FIELDS``)
hold their defaults in all of them."""
import dataclasses

import pytest
import torch

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro_torch.configs import all_configs, get_config
from repro_torch.models.common import PORT_FIELDS

ARCHS = sorted(jax_all_configs())


def jax_fields(cfg) -> dict:
    """``cfg``'s fields that the JAX package's config has, asserting that
    each port-only field holds its default."""
    fields = dataclasses.asdict(cfg)
    for name, default in PORT_FIELDS.items():
        assert fields.pop(name) == default, name
    return fields


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    ours, ref = get_config(arch), jax_get_config(arch)
    assert jax_fields(ours) == dataclasses.asdict(ref)
    assert jax_fields(ours.reduced()) == dataclasses.asdict(ref.reduced())
    assert ours.q_per_kv == ref.q_per_kv


def test_registry_and_torch_dtypes():
    assert sorted(all_configs()) == ARCHS
    cfg = get_config("llama3-3b")
    assert cfg.activation_dtype is torch.bfloat16
    assert cfg.reduced().weight_dtype is torch.float32
    # frozen and hashable: the cost model caches on it
    assert hash(cfg) == hash(get_config("llama3-3b").replace())
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.num_layers = 1
