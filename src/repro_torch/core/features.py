"""The 7-dimensional privacy-preserving workload fingerprint (paper §3.3,
§4.1).

Consumes ONLY aggregate window statistics differenced from the engine's
Prometheus-style exporter — never per-request prompt content or lengths.
Dimensions (order fixed, matches the paper):

    x1 has_queue        1[requests_waiting > 0]
    x2 prefill_tput     new prompt tokens / s
    x3 decode_tput      generated tokens / s
    x4 packing_eff      tokens per engine iteration
    x5 concurrency      requests currently running
    x6 cache_usage      KV-block pool occupancy [0,1]
    x7 cache_hit_rate   prefix-cache hit fraction [0,1]
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.energy.edp import WindowStats

FEATURE_NAMES = ("has_queue", "prefill_tput", "decode_tput", "packing_eff",
                 "concurrency", "cache_usage", "cache_hit_rate")


@dataclasses.dataclass
class FeatureScales:
    """Fixed normalization scales so LinUCB sees O(1) features. Defaults fit
    a single-GPU vLLM-class server; they are scales, not clamps of meaning —
    values are clipped to [0, 1.5] to bound the bandit's design matrix."""
    prefill_tput: float = 20_000.0     # tokens/s
    decode_tput: float = 4_000.0       # tokens/s
    packing_eff: float = 1_024.0       # tokens/iteration
    concurrency: float = 64.0          # max_num_seqs


class FeatureExtractor:
    def __init__(self, scales: Optional[FeatureScales] = None):
        self.scales = scales or FeatureScales()

    @property
    def dim(self) -> int:
        return len(FEATURE_NAMES)

    def __call__(self, w: WindowStats) -> np.ndarray:
        s = self.scales
        dur = max(w.duration_s, 1e-9)
        raw = np.array([
            1.0 if w.requests_waiting > 0 else 0.0,
            (w.prefill_tokens / dur) / s.prefill_tput,
            (w.generation_tokens / dur) / s.decode_tput,
            ((w.prefill_tokens + w.generation_tokens)
             / max(w.iterations, 1)) / s.packing_eff,
            w.requests_running / s.concurrency,
            w.gpu_cache_usage,
            w.cache_hit_rate,
        ], dtype=np.float64)
        return np.clip(raw, 0.0, 1.5)
