"""Power policies of the port: the registry, the windowed-policy base, the
paper's AGFT tuner (``agft``, ``agft-naive``, ``agft-switchcost``) and its
baselines, the fixed clocks (``static``, ``oracle``) and the rule-based
governors (``ondemand``, ``slo``, ``slo-ttft``). The phased and fleet-scope
policies of ``repro.policies`` are not ported yet."""
from repro_torch.policies.base import (PowerPolicy, TelemetryRecorder,
                                       WindowedPolicy)
from repro_torch.policies.registry import (available_policies, get_policy,
                                           register_policy)
from repro_torch.policies.fixed import (OracleFixedPolicy, StaticPolicy,
                                        snap_to_grid)
from repro_torch.policies.rules import OndemandPolicy, SLOAwareLatencyPolicy
from repro_torch.policies.agft import make_agft, make_agft_switchcost

__all__ = ["PowerPolicy", "WindowedPolicy", "TelemetryRecorder",
           "available_policies", "get_policy", "register_policy",
           "StaticPolicy", "OracleFixedPolicy", "OndemandPolicy",
           "SLOAwareLatencyPolicy", "snap_to_grid", "make_agft",
           "make_agft_switchcost"]
