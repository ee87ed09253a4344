"""Hand-written Hopper kernels of the port, one module per TPU kernel on the
serving path, each with its plain PyTorch version and a launch count:

=================  =======  ==========================================
module             route    replaces
=================  =======  ==========================================
rmsnorm            CUDA     repro/kernels/rmsnorm.py::rmsnorm_kernel
flash_attention    CUDA     repro/kernels/flash_attention.py::
                            flash_attention_bhsd
decode_attention   CUDA     repro/kernels/decode_attention.py::
                            decode_attention_grouped
ssd                CUDA     repro/kernels/ssd.py::ssd_scan_kernel
rglru              CUDA     repro/kernels/rglru.py::rglru_scan_kernel
                            (alone, or with the RG-LRU block's gates)
=================  =======  ==========================================
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.decode_attention import decode_attention as _dec
from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.kernels.rglru import rglru_scan as _rglru
from repro_torch.kernels.rmsnorm import rmsnorm as _rms
from repro_torch.kernels.ssd import ssd_scan as _ssd

#: the kernel wrappers by name; each carries a ``launches`` count that it
#: raises by one where it launches its kernel, and nowhere else
WRAPPERS = {"rmsnorm": _rms, "flash_attention": _fa,
            "decode_attention": _dec, "ssd_scan": _ssd,
            "rglru_scan": _rglru}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    _rms.fused_launches = 0
    _rglru.gated_launches = _rglru.step_launches = 0


def launch_counts() -> Dict[str, int]:
    """Each wrapper's launches; ``rmsnorm_fused``: the RMSNorm launches that
    took the residual add in (counted in ``rmsnorm`` too); ``rglru_gated``
    and ``rglru_gated_step``: the RG-LRU launches that took the recurrent
    block's gates in, over two or more steps and over one (counted in
    ``rglru_scan`` too)."""
    counts = {name: fn.launches for name, fn in WRAPPERS.items()}
    counts["rmsnorm_fused"] = _rms.fused_launches
    counts["rglru_gated"] = _rglru.gated_launches
    counts["rglru_gated_step"] = _rglru.step_launches
    return counts


__all__ = ["WRAPPERS", "launch_counts", "reset_launch_counts"]
