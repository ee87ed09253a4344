"""Name-keyed policy registry.

Factories take ``(hardware, **kwargs)`` and return a ``PowerPolicy``.
Registering a class works because classes are callable with that
signature; any callable does.

Entries carry a *scope* — ``"node"`` (default; one controller per
engine) or ``"fleet"`` (one controller per cluster, e.g. ``global`` and
``hierarchy``; see ``repro.policies.fleet`` / ``repro.policies.
hierarchy``). The scope is read off the registered factory (class
attribute) so CLIs can offer only the names valid for their attachment
point: ``available_policies(scope="node")``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.energy.power_model import A6000, HardwareSpec

_REGISTRY: Dict[str, Callable] = {}


def register_policy(name: str) -> Callable:
    """Decorator: ``@register_policy("static")`` on a class or factory."""
    def deco(factory: Callable) -> Callable:
        key = name.lower()
        if key in _REGISTRY:
            raise ValueError(f"policy {name!r} already registered")
        _REGISTRY[key] = factory
        return factory
    return deco


def get_policy(name: str, hardware: HardwareSpec = A6000, **kwargs):
    """Construct a registered policy by name.

    >>> get_policy("agft")          # paper tuner, default config
    >>> get_policy("static", frequency_mhz=1200.0)
    >>> get_policy("hierarchy", power_cap_w=800.0)   # fleet scope
    """
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown policy {name!r}; available: "
                       f"{', '.join(available_policies())}")
    return _REGISTRY[key](hardware, **kwargs)


def policy_scope(name: str) -> str:
    """Declared scope of a registered entry ("node" unless the factory
    says otherwise) without constructing it."""
    return getattr(_REGISTRY[name.lower()], "scope", "node")


def available_policies(scope: Optional[str] = None) -> List[str]:
    """Sorted registry names, optionally filtered to one scope."""
    return sorted(n for n in _REGISTRY
                  if scope is None or policy_scope(n) == scope)
