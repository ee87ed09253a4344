"""CUDA graphs, the port's counterpart of ``jax.jit``: a step captured once
on the card and replayed as one launch from the host.

``StepGraph(fn, device)`` takes a callable of no arguments. Its inputs are
tensors it closes over, which the caller writes in place between calls;
its output is the tensor (or tuple of tensors) it returns, which every
replay overwrites. On a CUDA device the constructor runs ``fn`` once on a
side stream (the warm-up that ``torch.cuda.graphs`` asks for: it also loads
each kernel's library and fills the launch plans' caches, so that no build,
``dlopen`` or attribute query happens inside the capture), then captures it
with ``torch.cuda.graph``. A failed capture raises; nothing falls back to
running ``fn`` eagerly on the card. On the CPU, which a caller chooses
explicitly, a call runs ``fn`` itself.

A replay runs no kernel wrapper, so no launch count moves by itself: the
capture records the counts its wrappers added (and takes them back, since
a capture launches nothing), and each replay adds them again through
``repro_torch.kernels.add_launch_counts``. ``launch_counts()`` thus counts
every launch that ran, eager or replayed.

The capture also records two CUDA events into the graph, one before the
step's first operation and one after its last (``cudaEventRecordExternal``
nodes): ``device_ms()`` reads the card's time between them in the last
replay, once the card has finished it. Under a ``torch.profiler`` the
card also waits between them for the profiled launch (milliseconds on an
H100), so the reading is the step's own time only where no profiler runs.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import add_launch_counts, launch_counts


class StepGraph:
    """``fn`` as a CUDA graph on a CUDA ``device``, eager on the CPU.

    ``pool`` is a memory pool shared with other graphs
    (``torch.cuda.graph_pool_handle()``): their outputs then stay valid
    only until the next replay of any graph of the pool. After capture,
    ``launches`` holds the kernel launches of one replay, ``capture_s``
    the wall time of the warm-up and the capture, and ``memory_bytes`` the
    device memory that the capture reserved for the graph
    (``torch.cuda.memory_reserved``); ``device_ms()`` the card's time of
    the last replay."""

    def __init__(self, fn: Callable, device: torch.device,
                 pool=None, name: str = "step"):
        self.fn = fn
        self.name = name
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.output = None
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0
        self.memory_bytes = 0
        self._events = None
        if device.type == "cuda":
            self._capture(device, pool)

    def _capture(self, device: torch.device, pool) -> None:
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.fn()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        # Python's cyclic collector must not run inside the capture: freeing
        # garbage that holds CUDA graphs or memory there is an operation a
        # capture forbids, and the capture fails (on the H100 a later
        # cuBLAS call reported it). Collect now, and pause it until the
        # capture ends.
        gc.collect()
        torch.cuda.empty_cache()      # as the capture's own entry does
        reserved = torch.cuda.memory_reserved(device)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        events = tuple(torch.cuda.Event(enable_timing=True, external=True)
                       for _ in range(2))
        for ev in events:             # created here, not inside the capture
            ev.record()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool):
                events[0].record()
                self.output = self.fn()
                events[1].record()
            torch.cuda.synchronize(device)
        except Exception as e:
            raise RuntimeError(
                f"capturing {self.name} as a CUDA graph failed: {e}") from e
        finally:
            gc.enable()
        after = launch_counts()
        self.launches = {k: n - before[k] for k, n in after.items()
                         if n != before[k]}
        add_launch_counts(self.launches, -1)    # the capture launched nothing
        self.graph = graph
        self._events = events
        self.capture_s = time.perf_counter() - t0
        self.memory_bytes = torch.cuda.memory_reserved(device) - reserved

    def __call__(self):
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        add_launch_counts(self.launches)
        return self.output

    def device_ms(self) -> Optional[float]:
        """The card's time of the last replay between the graph's two
        events (ms), once the card has finished it; None on the CPU. Read
        only after a replay."""
        if self._events is None:
            return None
        return self._events[0].elapsed_time(self._events[1])
