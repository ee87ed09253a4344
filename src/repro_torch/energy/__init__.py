from repro_torch.energy.power_model import (A6000, A6000_MEASURED,
                                            EDGE_ORIN, H100, HARDWARE,
                                            HW_CONST_COLS, L4, TPU_V5E,
                                            DVFSModel, HardwareSpec,
                                            hw_const_rows,
                                            parse_fleet_hardware,
                                            resolve_hardware)
from repro_torch.energy.costs import (CostModel, active_param_count,
                                      get_cost_model, iteration_cost,
                                      param_count)
from repro_torch.energy.edp import WindowStats, diff_snapshots
from repro_torch.energy.phases import phase_optimal_frequencies

__all__ = ["A6000", "A6000_MEASURED", "CostModel", "DVFSModel", "EDGE_ORIN",
           "H100", "HARDWARE", "HW_CONST_COLS", "HardwareSpec", "L4",
           "TPU_V5E", "WindowStats", "active_param_count", "diff_snapshots",
           "get_cost_model", "hw_const_rows", "iteration_cost",
           "param_count", "parse_fleet_hardware",
           "phase_optimal_frequencies", "resolve_hardware"]
