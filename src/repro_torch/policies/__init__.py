"""Power policies of the port: the registry, the windowed-policy base and
the paper's AGFT tuner (``agft``, ``agft-naive``, ``agft-switchcost``).
The rule-based, phased and fleet-scope policies of ``repro.policies`` are
not ported yet."""
from repro_torch.policies.base import (PowerPolicy, TelemetryRecorder,
                                       WindowedPolicy)
from repro_torch.policies.registry import (available_policies, get_policy,
                                           register_policy)
from repro_torch.policies.agft import make_agft, make_agft_switchcost

__all__ = ["PowerPolicy", "WindowedPolicy", "TelemetryRecorder",
           "available_policies", "get_policy", "register_policy",
           "make_agft", "make_agft_switchcost"]
