from repro_torch.workloads.prototypes import (PROTOTYPES, WorkloadSpec,
                                              generate_requests)

__all__ = ["PROTOTYPES", "WorkloadSpec", "generate_requests"]
