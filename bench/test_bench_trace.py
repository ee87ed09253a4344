"""The reduction of a device trace to the slice's busy time, its idle
gaps by host span, and each iteration's kernels; and the percentile."""
import pytest

from bench import trace
from bench.run import percentile


def _ev(name, a, b, cuda=False):
    return (name, cuda, a, b)


def test_reduce_by_hand():
    ev = [
        _ev("step", 0, 100), _ev("execute#0", 10, 90),
        _ev("k", 20, 80, True),                    # iteration 0: dropped
        _ev("step", 100, 200), _ev("execute#1", 110, 180),
        _ev("policy", 185, 195),
        _ev("a", 120, 140, True), _ev("b", 130, 150, True),
        _ev("a", 160, 170, True),
        _ev("step", 200, 300), _ev("execute#2", 210, 290),
        _ev("execute#2", 211, 289, True),        # the span's mark on the card
        _ev("submit", 295, 299),
        _ev("b", 220, 280, True),
    ]
    t = trace.reduce(ev)
    # window: execute#1's start (110) to the last step's end (300)
    assert t.window_s == pytest.approx(190e-6)
    # busy: 120-150, 160-170, 220-280
    assert t.busy_s == pytest.approx(100e-6)
    assert sorted(t.kernels) == [1, 2]
    assert [k[0] for k in t.kernels[1]] == ["a", "b", "a"]
    idle = dict(t.idle)
    # 110-120, 150-160, 170-180, 210-220 and 280-290 in execute;
    # 180-185, 195-210, 290-295 and 299-300 in a step outside execute,
    # policy and submit; 185-195 in the policy; 295-299 in a submission
    assert idle["execute"] == pytest.approx(50e-6)
    assert idle["policy"] == pytest.approx(10e-6)
    assert idle["schedule"] == pytest.approx(5e-6 + 15e-6 + 5e-6 + 1e-6)
    assert idle["submit"] == pytest.approx(4e-6)
    assert dict(t.ops)["b"] == pytest.approx(80e-6)
    assert trace.kernel_time(t.kernels[1], "a") == pytest.approx(30e-6)
    assert trace.busy_time(t.kernels[1]) == pytest.approx(40e-6)


def test_too_short_a_trace_reads_nothing():
    t = trace.reduce([_ev("step", 0, 10), _ev("execute#0", 1, 9)])
    assert t.busy_s == 0 and t.kernels == {}


def test_percentile():
    assert percentile([1, 2, 3, 4, 5], 50) == 3
    assert percentile([0, 10], 95) == pytest.approx(9.5)
    assert percentile(list(range(101)), 95) == pytest.approx(95)
