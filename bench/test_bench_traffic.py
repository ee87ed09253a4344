"""The one traffic generator: a seed gives the same requests every time,
within the mix's bounds, at the mix's rate."""
import json

import numpy as np
import pytest

from bench import traffic
from bench.cell import BENCH

MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))
SEEDS = [0, 7, 2**31 + 11, 3_000_000_019]


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_a_seed_repeats_exactly(name):
    mix = _mix(name)
    for seed in SEEDS:
        assert traffic.jobs(mix, seed) == traffic.jobs(mix, seed)
    if mix["loop"] == "closed":
        assert traffic.jobs(mix, SEEDS[2]) != traffic.jobs(mix, SEEDS[3])


@pytest.mark.parametrize("name", MIXES)
def test_lengths_stay_in_bounds(name):
    mix = _mix(name)
    jobs = traffic.jobs(mix, 5)
    assert len(jobs) == mix["requests"]
    p = np.array([j.prompt_len for j in jobs])
    o = np.array([j.output_len for j in jobs])
    assert p.min() >= mix["prompt"]["lo"] and p.max() <= mix["prompt"]["hi"]
    assert o.min() >= 1 and o.max() <= mix["output"]["hi"]
    if mix["loop"] == "closed":
        # only the first cohort is cut to a residual life
        assert o[mix["clients"]:].min() >= mix["output"]["lo"]
    assert max(j.template_id for j in jobs) < mix["templates"]


def test_open_loop_rate_and_bursts():
    mix = {"loop": "open", "rate_per_s": 10.0, "requests": 20000,
           "burst": {"period_s": 4.0, "factors": [0.5, 1.5]},
           "prompt": {"dist": "uniform", "lo": 1, "hi": 2},
           "output": {"dist": "uniform", "lo": 1, "hi": 2}, "templates": 1}
    t = np.array([j.arrival_s for j in traffic.jobs(mix, 3)])
    assert np.all(np.diff(t) >= 0)
    assert abs(len(t) / t[-1] - 10.0) < 0.3
    per_period = np.bincount((t // 4.0).astype(int))[:-1] / 4.0
    lo, hi = per_period.min(), per_period.max()
    assert lo < 7.5 < 12.5 < hi           # the rate swings 5 <-> 15


def test_lognormal_median():
    r = traffic.rng(1)
    x = traffic.lengths(r, {"dist": "lognormal", "median": 300,
                            "sigma": 0.8, "lo": 32, "hi": 2048}, 20000)
    assert 285 <= np.median(x) <= 315 and x.min() >= 32 and x.max() <= 2048


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_offers_the_same_set(name):
    """A seed changes the order of the mix's requests, not their sizes
    (nor, in the open loop, the arrival times)."""
    mix = _mix(name)
    a, b = traffic.jobs(mix, SEEDS[1]), traffic.jobs(mix, SEEDS[2])
    key = lambda j: (j.prompt_len, j.template_id)  # noqa: E731
    assert sorted(map(key, a)) == sorted(map(key, b))
    if mix["loop"] == "open":
        # (the closed loop cuts its first cohort's outputs by the seed)
        assert sorted(j.output_len for j in a) == \
            sorted(j.output_len for j in b)
    if mix["loop"] == "open":
        assert a == b
