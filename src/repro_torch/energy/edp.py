"""Energy-Delay-Product accounting (paper §2.3).

The paper's per-window EDP uses the decision window's energy and its
effective per-output-token delay (Tables 2/3: EDP ~= Energy_w x TPOT_w,
e.g. 231.6 J x 0.018 s ~= 4.07). We adopt exactly that:

    delay_w = busy_seconds_w / generation_tokens_w     (effective TPOT)
    EDP_w   = energy_w * delay_w

plus a MIXED variant whose delay adds a TTFT-pressure term
(delay = tpot_eff + ttft_weight * mean_ttft_w): the offline sweep and the
paper's SLO framing both weight first-token latency, and without it the
online optimum biases ~15-25% below the offline one (measured; see
EXPERIMENTS.md §Repro).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class WindowStats:
    """Differenced counters over one sampling window."""
    duration_s: float
    energy_j: float
    busy_s: float
    prefill_tokens: int
    cached_prompt_tokens: int
    generation_tokens: int
    iterations: int
    requests_running: int
    requests_waiting: int
    gpu_cache_usage: float
    cache_hit_rate: float
    mean_ttft_s: float = 0.0

    @property
    def effective_tpot(self) -> float:
        if self.generation_tokens <= 0:
            return self.duration_s          # stalled window: worst-case delay
        return self.busy_s / self.generation_tokens

    @property
    def edp(self) -> float:
        return self.energy_j * self.effective_tpot

    def edp_mixed(self, ttft_weight: float = 0.1) -> float:
        return self.energy_j * (self.effective_tpot
                                + ttft_weight * self.mean_ttft_s)

    @property
    def power_w(self) -> float:
        return self.energy_j / self.duration_s if self.duration_s else 0.0


def diff_snapshots(prev: Dict[str, float], cur: Dict[str, float],
                   duration_s: float) -> WindowStats:
    d = lambda k: cur[k] - prev[k]   # noqa: E731
    hits = d("vllm:prefix_cache_hits_total")
    queries = d("vllm:prefix_cache_queries_total")
    return WindowStats(
        duration_s=duration_s,
        energy_j=d("vllm:energy_joules_total"),
        busy_s=d("vllm:busy_seconds_total"),
        prefill_tokens=int(d("vllm:prompt_tokens_total")),
        cached_prompt_tokens=int(d("vllm:cached_prompt_tokens_total")),
        generation_tokens=int(d("vllm:generation_tokens_total")),
        iterations=int(d("vllm:iterations_total")),
        requests_running=int(cur["vllm:num_requests_running"]),
        requests_waiting=int(cur["vllm:num_requests_waiting"]),
        gpu_cache_usage=float(cur["vllm:gpu_cache_usage_perc"]),
        cache_hit_rate=hits / queries if queries > 0 else 0.0,
        mean_ttft_s=(d("vllm:ttft_seconds_total")
                     / max(d("vllm:ttft_count_total"), 1)),
    )
