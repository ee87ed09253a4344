"""Registry entries for the paper's tuner: AGFT *is* a PowerPolicy.

``AGFTTuner`` already conforms structurally (``maybe_act(engine) ->
Optional[float]``, the ``tick`` hook for pure POLICY_TICK scheduling,
telemetry via the shared ``TelemetryMonitor``, and the optional band hook
``set_band(f_lo, f_hi)`` — implemented by masking LinUCB arms outside the
fleet-assigned band, see ``repro.policies.hierarchy``); this module only
adapts its constructor signature to the registry's ``(hardware,
**kwargs)`` convention, plus two ablation variants: the fault-naive
learner (``agft-naive``) and the switching-cost-aware reward
(``agft-switchcost``). The phase-disaggregated 2-D variant (``agft-2d``)
lives in ``repro.policies.phased`` with its rule comparator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.tuner import AGFTConfig, AGFTTuner
from repro_torch.energy.power_model import HardwareSpec
from repro_torch.policies.registry import register_policy

#: default DVFS transition price for ``agft-switchcost`` when the hardware
#: spec doesn't declare one: ~an A6000-class board stalling O(10 ms) at
#: near-busy power per PLL relock, plus the pipeline-refill glitch —
#: conservative but the right order (switching-aware bandits,
#: arXiv:2410.11855, price exactly this regularizer).
DEFAULT_SWITCH_COST_J = 15.0


@register_policy("agft")
def make_agft(hardware: HardwareSpec, cfg: Optional[AGFTConfig] = None,
              **kwargs) -> AGFTTuner:
    """``get_policy("agft")`` | ``get_policy("agft", cfg=AGFTConfig(...))``
    | ``get_policy("agft", strategy="thompson", ...)`` — extra kwargs are
    AGFTConfig fields."""
    if cfg is not None and kwargs:
        raise TypeError("pass either cfg= or AGFTConfig field kwargs")
    return AGFTTuner(hardware, cfg or AGFTConfig(**kwargs))


@register_policy("agft-naive")
def make_agft_naive(hardware: HardwareSpec,
                    cfg: Optional[AGFTConfig] = None,
                    **kwargs) -> AGFTTuner:
    """AGFT with graceful degradation disabled (``fault_aware=False``):
    under fault injection (``repro.serving.faults``) it credits faulted
    and stale telemetry windows into the LinUCB bank and never re-issues
    stuck actuations — the poisoned-feedback baseline the resilient
    tuner is measured against in ``benchmarks/tab_faults.py``. On a
    healthy engine it is exactly ``agft``."""
    if cfg is not None and kwargs:
        raise TypeError("pass either cfg= or AGFTConfig field kwargs")
    cfg = cfg or AGFTConfig(**kwargs)
    return AGFTTuner(hardware,
                     dataclasses.replace(cfg, fault_aware=False))


@register_policy("agft-switchcost")
def make_agft_switchcost(hardware: HardwareSpec,
                         switch_cost_j: Optional[float] = None,
                         cfg: Optional[AGFTConfig] = None,
                         **kwargs) -> AGFTTuner:
    """AGFT with a switching-cost-aware reward: frequency *changes* are
    billed ``switch_cost_j`` joules into the credited window's EDP, so the
    bandit learns to hold its operating point unless moving pays for the
    transition. The cost defaults to the hardware spec's
    ``dvfs_transition_cost_j`` when it prices transitions, else
    ``DEFAULT_SWITCH_COST_J``."""
    if cfg is not None and kwargs:
        raise TypeError("pass either cfg= or AGFTConfig field kwargs")
    cost = (switch_cost_j if switch_cost_j is not None
            else (hardware.dvfs_transition_cost_j or DEFAULT_SWITCH_COST_J))
    cfg = cfg or AGFTConfig(**kwargs)
    cfg = dataclasses.replace(
        cfg, reward=dataclasses.replace(cfg.reward, switch_cost_j=cost))
    return AGFTTuner(hardware, cfg)
