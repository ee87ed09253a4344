from repro_torch.workloads.azure_trace import generate_azure_trace
from repro_torch.workloads.prototypes import (PROTOTYPES, WorkloadSpec,
                                              generate_requests)

__all__ = ["PROTOTYPES", "WorkloadSpec", "generate_requests",
           "generate_azure_trace"]
