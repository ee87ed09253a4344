from repro_torch.serving.driver import (EngineNode, EventKind, EventLoop,
                                        POLICY_TICK_MODES, drive)
from repro_torch.serving.engine import (EngineConfig, InferenceEngine,
                                        SimBackend, TorchBackend)
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.metrics import MetricsExporter
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import (BatchPlan,
                                           ContinuousBatchingScheduler)

__all__ = ["EngineConfig", "EngineNode", "EventKind", "EventLoop",
           "InferenceEngine", "SimBackend", "TorchBackend", "PagedKVCache",
           "MetricsExporter", "POLICY_TICK_MODES", "Request",
           "RequestState", "BatchPlan", "ContinuousBatchingScheduler",
           "drive"]
