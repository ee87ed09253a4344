"""Prometheus-style metrics exporter for the serving engine.

Mirrors the vLLM exporter the paper scrapes (§4.1 "Periodic Metric
Acquisition"): monotonically-increasing counters plus point-in-time gauges.
The AGFT monitor polls ``snapshot()`` on its sampling period and differences
consecutive snapshots — exactly the REST/Prometheus pattern, and the ONLY
interface the tuner is allowed to read (privacy boundary)."""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class EngineCounters:
    # counters (monotonic)
    prompt_tokens_total: int = 0         # new prefill tokens computed
    cached_prompt_tokens_total: int = 0  # prompt tokens served by prefix cache
    generation_tokens_total: int = 0
    iterations_total: int = 0
    requests_finished_total: int = 0
    # deadline-expired requests shed at admission (load shedding; fault
    # retry-budget drops are accounted at the fault model, not per engine)
    requests_dropped_total: int = 0
    prefix_cache_hits_total: int = 0
    prefix_cache_queries_total: int = 0
    energy_joules_total: float = 0.0
    busy_seconds_total: float = 0.0
    # aggregate first-token latency (vLLM exports TTFT histograms; an
    # aggregate sum/count is privacy-preserving — no per-request identity)
    ttft_seconds_total: float = 0.0
    ttft_count_total: int = 0
    # actual frequency changes actuated (DVFS transitions are not free;
    # the switching-cost reward and fleet telemetry both consume this)
    freq_transitions_total: int = 0

    # gauges (point-in-time)
    requests_running: int = 0
    requests_waiting: int = 0
    gpu_cache_usage: float = 0.0
    current_frequency_mhz: float = 0.0
    current_power_watts: float = 0.0


class MetricsExporter:
    def __init__(self):
        self.c = EngineCounters()

    def snapshot(self) -> Dict[str, float]:
        """Flat dict, prometheus-naming; this is the tuner-visible surface."""
        c = self.c
        return {
            "vllm:prompt_tokens_total": c.prompt_tokens_total,
            "vllm:cached_prompt_tokens_total": c.cached_prompt_tokens_total,
            "vllm:generation_tokens_total": c.generation_tokens_total,
            "vllm:iterations_total": c.iterations_total,
            "vllm:requests_finished_total": c.requests_finished_total,
            "vllm:requests_dropped_total": c.requests_dropped_total,
            "vllm:prefix_cache_hits_total": c.prefix_cache_hits_total,
            "vllm:prefix_cache_queries_total": c.prefix_cache_queries_total,
            "vllm:energy_joules_total": c.energy_joules_total,
            "vllm:busy_seconds_total": c.busy_seconds_total,
            "vllm:ttft_seconds_total": c.ttft_seconds_total,
            "vllm:ttft_count_total": c.ttft_count_total,
            "vllm:freq_transitions_total": c.freq_transitions_total,
            "vllm:num_requests_running": c.requests_running,
            "vllm:num_requests_waiting": c.requests_waiting,
            "vllm:gpu_cache_usage_perc": c.gpu_cache_usage,
            "vllm:current_frequency_mhz": c.current_frequency_mhz,
            "vllm:current_power_watts": c.current_power_watts,
        }
