"""``mla_decode_roofline``: its bytes against a hand count at a tiny
configuration, and what it reads from a traced run, an untraced one and
a program without the kernel."""
import types

import pytest

from bench import peaks
from bench.cell import BENCH, load_module
from bench.serve import Iteration

metric = load_module(BENCH / "metrics" / "mla_decode_roofline.py", "test")


def test_mla_decode_bytes_by_hand():
    # rows at contexts 0 and 5, 2 heads, rank 3, rope 1, bf16: latents
    # (1 + 6) x 4 wide; q 2 x 4 and o 2 x 3 a row
    want = 2 * ((1 * 4 + 2 * 4 + 2 * 3) + (6 * 4 + 2 * 4 + 2 * 3))
    assert metric.mla_decode_bytes([0, 5], heads=2, rank=3, rope=1) == want
    assert metric.mla_decode_bytes([], heads=2, rank=3, rope=1) == 0


def _run(traced, launches):
    its = [Iteration(rows=2, contexts=[0, 5], bucket=0, f_mhz=1980.0,
                     wall_s=0.0, dt_s=0.0),
           Iteration(rows=0, contexts=[], bucket=64, f_mhz=1980.0,
                     wall_s=0.0, dt_s=0.0),
           Iteration(rows=1, contexts=[9], bucket=64, f_mhz=1980.0,
                     wall_s=0.0, dt_s=0.0)]
    cfg = {"model_config": {"num_heads": 2, "kv_lora_rank": 3,
                            "qk_rope_head_dim": 1}}
    return types.SimpleNamespace(traced=traced, config=cfg,
                                 all_iterations=its,
                                 decode_launches=launches)


def _traced(kernels):
    return types.SimpleNamespace(kernels=kernels)


def test_reads_the_kernels_of_the_iterations_with_decode_rows():
    # (name, start us, duration us); the prefill-only iteration's kernel
    # and other kernels are not the metric's
    kernels = {
        0: [("void mla_decode_tile_kernel<512, 64>", 0.0, 3.0),
            ("void mla_decode_merge_kernel<bf16>", 3.0, 1.0),
            ("rmsnorm_kernel", 4.0, 2.0)],
        1: [("mla_decode_tile_kernel", 0.0, 50.0)],
        2: [("mla_decode_tile_kernel", 0.0, 4.0)],
    }
    got = metric.read(_run(_traced(kernels), {"mla_decode": 3}))
    bound = 3 * (peaks.bound_s(0.0, metric.mla_decode_bytes([0, 5], 2, 3, 1))
                 + peaks.bound_s(0.0, metric.mla_decode_bytes([9], 2, 3, 1)))
    assert got == pytest.approx(100.0 * bound / 8e-6)


def test_reads_none_untraced_or_without_the_kernel():
    assert metric.read(_run(None, {"mla_decode": 3})) is None
    # a program whose decode graph launches no such kernel (the parent's)
    parent = {0: [("void gemv_kernel", 0.0, 3.0)]}
    assert metric.read(_run(_traced(parent), {"rmsnorm": 5})) is None
