from repro_torch.serving.driver import (EngineNode, EventKind, EventLoop,
                                        POLICY_TICK_MODES, drive)
from repro_torch.serving.engine import (EngineConfig, InferenceEngine,
                                        SimBackend, TorchBackend)
from repro_torch.serving.faults import (FaultConfig, FaultModel,
                                        PRESETS as FAULT_PRESETS,
                                        parse_fault_spec)
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.metrics import MetricsExporter
from repro_torch.serving.network import (DeliverySchedule, NetworkConfig,
                                         NetworkModel,
                                         PRESETS as NETWORK_PRESETS)
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import (BatchPlan,
                                           ContinuousBatchingScheduler)

__all__ = ["EngineConfig", "EngineNode", "EventKind", "EventLoop",
           "InferenceEngine", "SimBackend", "TorchBackend", "PagedKVCache",
           "MetricsExporter", "NetworkConfig", "NetworkModel",
           "NETWORK_PRESETS", "DeliverySchedule", "POLICY_TICK_MODES",
           "FaultConfig", "FaultModel", "FAULT_PRESETS",
           "parse_fault_spec", "Request", "RequestState", "BatchPlan",
           "ContinuousBatchingScheduler", "drive"]
