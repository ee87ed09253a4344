"""The one generator of every traffic mix: a mix is a file of parameters
(``traffic/<name>.json``), and this module turns it and a seed into the
requests a run offers. It knows nothing of the program; ``serve.py`` makes
the program's requests from what it returns.

A mix's keys:

- ``loop``: ``"closed"`` (``clients`` callers, each sending its next
  request when the last one finishes, after ``think_s``) or ``"open"``
  (Poisson arrivals at ``rate_per_s`` on the engine's clock, multiplied by
  ``burst.factors`` in turn, each for ``burst.period_s``);
- ``prompt``, ``output``: a length distribution, ``{"dist": "uniform",
  "lo", "hi"}`` (both ends included) or ``{"dist": "lognormal", "median",
  "sigma", "lo", "hi"}`` (clipped to [lo, hi]);
- ``templates``, ``template_frac``: the prompt templates that prefixes are
  shared from, and the share of a prompt that its template covers;
- ``requests``: how many requests the seed draws (the closed loop takes
  them in order; the open loop's arrivals end with the last);
- ``max_batch``, ``cache_len``, ``num_kv_blocks``: the backend's and the
  engine's sizes; ``policy`` and ``policy_args``: the power policy;
  ``warmup_iterations``: engine iterations run before the window opens.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Job:
    prompt_len: int
    output_len: int
    template_id: int
    arrival_s: float = 0.0      # the open loop's arrival on the engine clock


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a stream of it."""
    return np.random.default_rng([seed % 2**64, stream])


def lengths(r: np.random.Generator, dist: dict, n: int) -> np.ndarray:
    if dist["dist"] == "uniform":
        return r.integers(dist["lo"], dist["hi"] + 1, size=n)
    if dist["dist"] == "lognormal":
        x = np.exp(np.log(dist["median"]) + dist["sigma"]
                   * r.standard_normal(n))
        return np.clip(np.rint(x), dist["lo"], dist["hi"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def arrivals(r: np.random.Generator, mix: dict, n: int) -> np.ndarray:
    """``n`` Poisson arrivals (s) whose rate switches between
    ``rate_per_s`` x each of ``burst.factors`` every ``burst.period_s``;
    the phase of the switching and the gaps are drawn from ``r``."""
    burst = mix.get("burst") or {"period_s": 1.0, "factors": [1.0]}
    period, factors = burst["period_s"], burst["factors"]
    rates = mix["rate_per_s"] * np.asarray(factors, dtype=np.float64)
    phase = r.uniform(0.0, period * len(factors))
    gaps = r.exponential(1.0, size=n)
    # time-rescaling: unit-rate arrivals mapped through the inverse of the
    # integrated rate, one period at a time
    marks = np.cumsum(gaps)
    out = np.empty(n)
    t, done, k = 0.0, 0.0, int(phase // period)
    left = period - phase % period          # what is left of this period
    i = 0
    while i < n:
        rate = rates[k % len(rates)]
        span = rate * left
        while i < n and marks[i] <= done + span:
            out[i] = t + (marks[i] - done) / rate
            i += 1
        done += span
        t += left
        k += 1
        left = period
    return out


#: the stream that draws a mix's set of requests and, in the open loop, its
#: arrival times: every seed offers the same sizes (the closed loop in an
#: order of its own; the open loop at the same times), so that the seed
#: does not change how much work there is
SET_STREAM = 0x5E7


def jobs(mix: dict, seed: int) -> List[Job]:
    """The requests that ``seed`` offers for ``mix``, in the order they are
    offered: the mix's one set of requests, shuffled by the seed in a
    closed loop, in the set's own order in an open loop."""
    n = mix["requests"]
    r = rng(SET_STREAM)
    prompt = lengths(r, mix["prompt"], n)
    output = lengths(r, mix["output"], n)
    template = r.integers(0, mix["templates"], size=n)
    if mix["loop"] == "closed":
        # (the open loop keeps the set's order: against its one schedule of
        # arrivals, the order of sizes decides the queueing, and with it
        # the work in the window)
        order = rng(seed).permutation(n)
        prompt, output = prompt[order], output[order]
        template = template[order]
    r = rng(seed, 2)
    if mix["loop"] == "closed":
        # each client's first request has its output cut to what is left
        # of it at a random point of its life, so the run starts from the
        # mixture of ages that a steady closed loop holds, not one cohort
        c = mix["clients"]
        output[:c] = 1 + np.floor(r.uniform(0, 1, size=c)
                                  * output[:c]).astype(np.int64)
        when = np.zeros(n)
    elif mix["loop"] == "open":
        # one schedule of arrival times and one order of requests for
        # every seed: the seed changes only the weights that the run draws
        when = arrivals(rng(SET_STREAM, 1), mix, n)
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    return [Job(int(p), int(o), int(t), float(a))
            for p, o, t, a in zip(prompt, output, template, when)]
