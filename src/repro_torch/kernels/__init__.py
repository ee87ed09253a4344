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
mla_decode         CUDA     no Pallas kernel: MLA decode in the latent
                            space, in place of the up-projected einsums
                            of repro/models/attention.py::mla_decode
=================  =======  ==========================================
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import decode_attention as _dec
from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.kernels.mla_decode import mla_decode as _mla
from repro_torch.kernels.rglru import rglru_scan as _rglru
from repro_torch.kernels.rmsnorm import rmsnorm as _rms
from repro_torch.kernels.ssd import ssd_scan as _ssd

#: the kernel wrappers by name; each carries a ``launches`` count that it
#: raises by one where it launches its kernel, and nowhere else
WRAPPERS = {"rmsnorm": _rms, "flash_attention": _fa,
            "decode_attention": _dec, "ssd_scan": _ssd,
            "rglru_scan": _rglru, "mla_decode": _mla}
# every count: (the wrapper that holds it, its attribute)
_COUNTERS = {**{name: (fn, "launches") for name, fn in WRAPPERS.items()},
             "rmsnorm_fused": (_rms, "fused_launches"),
             "rglru_gated": (_rglru, "gated_launches"),
             "rglru_gated_step": (_rglru, "step_launches")}


#: what a profiler's trace shows of each count: the device kernels that
#: one of its launches runs, a group each, named by parts of their names;
#: a launch runs one kernel of each group
DEVICE_KERNELS = {
    "rmsnorm": ("rmsnorm", ("rmsnorm_kernel",)),
    "flash_attention": ("flash_attention", ("flash_fwd_kernel",
                                            "flash_mma_kernel")),
    "decode_attention": ("decode_attention", ("decode_partial_kernel",
                                              "decode_mma_kernel")),
    "decode_combine": ("decode_attention", ("decode_combine_kernel",)),
    "ssd_scan": ("ssd_scan", ("ssd_scan_kernel",)),
    "rglru_scan": ("rglru_scan", ("rglru_scan_kernel",)),
    "mla_decode": ("mla_decode", ("mla_decode_tile_kernel",
                                  "mla_decode_f32_kernel")),
    "mla_decode_list": ("mla_decode", ("mla_decode_list_kernel",)),
    "mla_decode_merge": ("mla_decode", ("mla_decode_merge_kernel",)),
}


def build() -> None:
    """Compile every kernel's CUDA source now, all ``nvcc`` runs at once,
    rather than each at its first launch."""
    _build.build_all()


def reset_launch_counts() -> None:
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)


def launch_counts() -> Dict[str, int]:
    """Each wrapper's launches; ``rmsnorm_fused``: the RMSNorm launches that
    took the residual add in (counted in ``rmsnorm`` too); ``rglru_gated``
    and ``rglru_gated_step``: the RG-LRU launches that took the recurrent
    block's gates in, over two or more steps and over one (counted in
    ``rglru_scan`` too)."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def add_launch_counts(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` to the counts: what a CUDA graph's replay
    launched, ``counts`` being the launches its capture recorded (a replay
    runs no wrapper, so no count moves by itself)."""
    for name, n in counts.items():
        fn, attr = _COUNTERS[name]
        setattr(fn, attr, getattr(fn, attr) + times * n)


def device_launches(counts: Dict[str, int], times: int = 1
                    ) -> Dict[str, int]:
    """The kernels of each ``DEVICE_KERNELS`` group that ``times`` x
    ``counts`` launches run."""
    return {group: times * counts.get(count, 0)
            for group, (count, _) in DEVICE_KERNELS.items()}


def profile_calls(fn, calls: int, cpu: bool = False):
    """``torch.profiler`` over ``calls`` calls of ``fn`` on the card, and
    the launch counts' rise over them: (its ``key_averages()``, the counts
    risen, the wall time of one call in s). One more call before them is
    the profiler's warm-up step, traced and dropped: on the H100 it has
    lost kernels at a trace's start (and, more rarely, elsewhere). The
    events hold the step's own span, ``ProfilerStep*``."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        before = launch_counts()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls
        after = launch_counts()
    return (prof.key_averages(), {k: n - before[k] for k, n in after.items()},
            wall)


def traced_launches(events) -> Dict[str, int]:
    """The kernels of each ``DEVICE_KERNELS`` group that a profiler saw:
    ``events`` is its ``key_averages()``."""
    from torch.autograd import DeviceType
    return {group: sum(e.count for e in events
                       if e.device_type != DeviceType.CPU
                       and any(n in e.key for n in names))
            for group, (_, names) in DEVICE_KERNELS.items()}


__all__ = ["DEVICE_KERNELS", "WRAPPERS", "add_launch_counts", "build",
           "device_launches", "launch_counts", "profile_calls",
           "reset_launch_counts", "traced_launches"]
