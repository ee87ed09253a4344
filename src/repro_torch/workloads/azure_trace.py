"""Synthetic regeneration of the Azure 2024 LLM-inference trace statistics
the paper evaluates against (§2.4, §5.1: "20% random sampling of the Azure
2024 conversational trace").

The real trace is not available offline, so we resample its *published*
statistics: 91.6% context-heavy / 8.3% balanced / 0.1% generation-heavy mix
(paper Fig. 3), hourly-mean input lengths oscillating in the 1200-2100 token
band with heavy right tails (std bound ~3500, Fig. 4), outputs stable at
100-200 tokens, plus Poisson arrivals whose rate drifts hour-by-hour —
the non-stationarity that breaks offline-profiled DVFS policies.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.serving.request import Request

MIX_2024 = {"context_heavy": 0.916, "balanced": 0.083,
            "generation_heavy": 0.001}
MIX_2023 = {"context_heavy": 0.458, "balanced": 0.527,
            "generation_heavy": 0.015}


def _sample_lengths(rng, kind: str, hour_mean_ctx: float):
    if kind == "context_heavy":
        # lognormal with hourly drifting mean, clipped to the trace's band
        ctx = int(np.clip(rng.lognormal(np.log(hour_mean_ctx), 0.9),
                          64, 16384))
        gen = int(np.clip(rng.normal(150, 40), 1, 400))
    elif kind == "balanced":
        ctx = int(np.clip(rng.normal(600, 250), 32, 4096))
        gen = int(np.clip(rng.normal(250, 80), 16, 800))
    else:  # generation_heavy
        ctx = int(np.clip(rng.normal(120, 60), 1, 512))
        gen = int(np.clip(rng.normal(700, 150), 200, 2000))
    return ctx, gen


def generate_azure_trace(duration_s: float, *, base_rate: float = 1.0,
                         year: int = 2024, template_pool: int = 200,
                         seed: int = 0) -> List[Request]:
    """Non-stationary request stream over ``duration_s`` simulated seconds.

    Hourly segments re-draw the context-length mean (1200-2100 band) and the
    arrival-rate multiplier (0.5x-2.0x), reproducing the paper's intra-week
    volatility at a compressed timescale (1 "hour" = 600 sim-seconds so the
    12-hour experiment has ~72 regime shifts)."""
    rng = np.random.default_rng(seed)
    mix = MIX_2024 if year == 2024 else MIX_2023
    kinds = list(mix.keys())
    probs = np.array([mix[k] for k in kinds])
    probs = probs / probs.sum()

    hour_len = 600.0
    out: List[Request] = []
    t = 0.0
    while t < duration_s:
        hour_mean_ctx = rng.uniform(1200, 2100)
        rate = base_rate * rng.uniform(0.5, 2.0)
        hour_end = min(t + hour_len, duration_s)
        while t < hour_end:
            t += rng.exponential(1.0 / rate)
            if t >= hour_end:
                break
            kind = kinds[int(rng.choice(len(kinds), p=probs))]
            ctx, gen = _sample_lengths(rng, kind, hour_mean_ctx)
            out.append(Request(
                arrival_time=t, prompt_len=ctx, output_len=gen,
                template_id=int(rng.integers(0, template_pool)),
                template_frac=0.9))
    return out
