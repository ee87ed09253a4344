"""``ssd_step_roofline``: its operations and bytes against a hand count at
a tiny configuration, and what it reads from a traced run, an untraced one
and a program without the kernel."""
import types

import pytest

from bench import peaks
from bench.cell import BENCH, load_module
from bench.serve import Iteration

metric = load_module(BENCH / "metrics" / "ssd_step_roofline.py", "test")
# 4 heads of P 2 (d_model 4, expand 2), one group, N 3
MODEL = {"d_model": 4, "ssm_expand": 2, "ssm_head_dim": 2, "ssm_ngroups": 1,
         "ssm_state": 3}


def test_ssd_step_cost_by_hand():
    # two rows: state 4 x 2 x 3 in and out, x and y 4 x 2, dt 4, B and C
    # 1 x 3 a row; A and D 4 each, once
    want = 4 * (2 * (2 * 24 + 2 * 8 + 4 + 2 * 3) + 2 * 4)
    assert metric.ssd_step_cost(2, 4, 2, 1, 3) == (2 * (6 * 24 + 2 * 8),
                                                   want)
    assert metric.ssd_step_cost(0, 4, 2, 1, 3) == (0.0, 0)


def _run(traced, launches):
    its = [Iteration(rows=2, contexts=[0, 5], bucket=0, f_mhz=1980.0,
                     wall_s=0.0, dt_s=0.0),
           Iteration(rows=0, contexts=[], bucket=64, f_mhz=1980.0,
                     wall_s=0.0, dt_s=0.0),
           Iteration(rows=1, contexts=[9], bucket=64, f_mhz=1980.0,
                     wall_s=0.0, dt_s=0.0)]
    return types.SimpleNamespace(traced=traced,
                                 config={"model_config": MODEL},
                                 all_iterations=its,
                                 decode_launches=launches)


def _traced(kernels):
    return types.SimpleNamespace(kernels=kernels)


@pytest.mark.parametrize("launches", [1, 48])
def test_reads_the_kernels_of_the_iterations_with_decode_rows(launches):
    # (name, start us, duration us); the prefill-only iteration's kernel
    # and the SSD scan are not the metric's
    kernels = {
        0: [("void (anonymous namespace)::ssd_step_kernel<128>", 0.0, 3.0),
            ("ssd_scan_kernel", 3.0, 1.0), ("rmsnorm_kernel", 4.0, 2.0)],
        1: [("ssd_step_kernel<128>", 0.0, 50.0)],
        2: [("ssd_step_kernel<128>", 0.0, 5.0)],
    }
    got = metric.read(_run(_traced(kernels), {"ssd_step": launches}))
    bound = launches * sum(
        peaks.bound_s(*metric.ssd_step_cost(rows, 4, 2, 1, 3), "fp32")
        for rows in (2, 1))
    assert got == pytest.approx(100.0 * bound / 8e-6)


def test_reads_none_untraced_or_without_the_kernel():
    assert metric.read(_run(None, {"ssd_step": 48})) is None
    # a program whose decode graph launches no such kernel (the parent's)
    parent = {0: [("elementwise_kernel", 0.0, 3.0), ("gemv2T_kernel", 3.0,
                                                     1.0)]}
    assert metric.read(_run(_traced(parent), {"rmsnorm": 49})) is None
