"""The paper's five workload prototypes (Table 1) and request generators.

Each prototype manipulates four knobs: context length, generation length,
concurrency (request-rate multiplier), and prompt-template pool size (the
prefix-cache locality control: 5 templates => High Cache Hit, 500 =>
cache-cold)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    context_range: tuple          # (lo, hi) prompt tokens
    generation_range: tuple       # (lo, hi) output tokens
    concurrency: float            # request-rate multiplier
    template_pool: int            # prompt templates (prefix-cache locality)
    template_frac: float = 0.9    # shared-prefix fraction of the prompt


# paper Table 1
PROTOTYPES: Dict[str, WorkloadSpec] = {
    "normal": WorkloadSpec("normal", (256, 1024), (100, 350), 1.0, 500),
    "long_context": WorkloadSpec("long_context", (1024, 8192), (1, 100),
                                 1.0, 500),
    "long_generation": WorkloadSpec("long_generation", (1, 256), (350, 350),
                                    1.0, 500),
    "high_concurrency": WorkloadSpec("high_concurrency", (256, 1024),
                                     (100, 350), 5.0, 500),
    "high_cache_hit": WorkloadSpec("high_cache_hit", (256, 1024), (100, 350),
                                   1.0, 5),
}


def generate_requests(spec: WorkloadSpec, n: int, *, base_rate: float = 1.0,
                      start_time: float = 0.0, seed: int = 0
                      ) -> List[Request]:
    """Poisson arrivals at base_rate*concurrency req/s, uniform lengths."""
    rng = np.random.default_rng(seed)
    rate = base_rate * spec.concurrency
    gaps = rng.exponential(1.0 / rate, size=n)
    arrivals = start_time + np.cumsum(gaps)
    lo_c, hi_c = spec.context_range
    lo_g, hi_g = spec.generation_range
    out: List[Request] = []
    for i in range(n):
        out.append(Request(
            arrival_time=float(arrivals[i]),
            prompt_len=int(rng.integers(lo_c, hi_c + 1)),
            output_len=int(rng.integers(lo_g, hi_g + 1)),
            template_id=int(rng.integers(0, spec.template_pool)),
            template_frac=spec.template_frac,
        ))
    return out
