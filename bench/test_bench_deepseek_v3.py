"""The ``deepseek-v3-671b.longctx`` cell at a small size on the CPU: a sound
run comes out correct, planted faults do not; the reference's sampled
steps; ``decode_flops`` and ``mla_decode_wide_roofline`` by hand.

The small cell is ``small.small_cell``'s MoE copy with DeepSeek-V3's
options set here: 4 heads, compressed queries (32 wide), a sigmoid router
over 32 experts in 8 groups (the top 4 within the best 2), 8 held, scaled
by 2.5, 1 leading dense layer of 3."""
import types

import pytest
import torch

from bench import control, peaks, run
from bench.cell import BENCH, load_cell, load_module
from bench.serve import Iteration
from bench.small import small_cell
from bench.test_bench_faults import _half_batch, _state_unchanged

NAME = "deepseek-v3-671b.longctx"
SEED = 2**31 + 303
V3 = dict(num_heads=4, num_kv_heads=4, q_lora_rank=32, router_experts=32,
          n_group=8, topk_group=2, top_k=4, num_experts=8, first_k_dense=1)
model = load_cell(NAME).model
metric = load_module(BENCH / "metrics" / "mla_decode_wide_roofline.py",
                     "test_v3")


def _cell():
    cell = small_cell(NAME)
    cell.config["model_config"].update(V3)
    return cell


def _run(prepare=None):
    return run.run_cell(NAME, SEED, 1.0, False, "cpu", cell=_cell(),
                        prepare=prepare)


def test_a_sound_small_run_is_correct():
    res = _run()
    assert res["correct"], res["check"]
    assert set(res["check"]) == {"cache_err", "head_residual",
                                 "tokens_miscounted"}
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_a_fault_is_not_correct(fault):
    res = _run(prepare=fault)
    assert not res["correct"], res["check"]


def test_the_control_is_not_correct():
    """The fp8 reference in the program's place fails the cell's limits,
    where the program passes them, over the same inputs."""
    out = control.readings(NAME, [SEED, SEED + 1], 2, 1.0, "cpu",
                           cell=_cell())
    limits = _cell().limits
    model_numbers = [k for k in limits if k != "tokens_miscounted"]
    for k in model_numbers:
        assert out["lower"][k] <= limits[k]
    assert any(out["upper"][k] > limits[k] for k in model_numbers)


def test_sampled_steps_see_the_final_cache():
    """A step is sampled only where no later step of its row writes at or
    below its slot; the last step of every row always is; at most
    ``STEPS_PER_ROW`` a row."""
    pos = torch.tensor([[5, 1], [6, 2], [3, 3], [4, 9], [7, 1]])
    ok = model.consistent_steps(pos)
    assert ok[:, 0].tolist() == [False, False, True, True, True]
    assert ok[:, 1].tolist() == [False, False, False, False, True]
    steps, rows = model.sampled_steps(pos)
    assert sorted(zip(rows.tolist(), steps.tolist())) == [
        (0, 2), (0, 3), (0, 4), (1, 4)]
    long = torch.arange(100)[:, None].expand(100, 3)
    steps, rows = model.sampled_steps(long, per_row=5)
    assert len(steps) == 15 and steps.max() == 99
    assert steps[rows == 0].tolist() == [0, 25, 50, 74, 99]


def test_the_reference_follows_the_teacher_and_copies_the_rest():
    """Through ``check.model_numbers``' calls: each layer's reference cache
    is the program's but at the sampled steps' slots; the program's own
    entries there give an error of 0, and a step's entry changed shows."""
    cell = _cell()
    cfg = cell.config
    gen = torch.Generator().manual_seed(5)
    params = model.make_weights(cfg, gen, "cpu")
    pos = torch.tensor([[3, 1], [4, 2], [5, 3]])
    teacher = []

    def keep(i, refs):
        teacher.append([r.clone() for r in refs])
    full = [[torch.zeros(2, 8, 32), torch.zeros(2, 8, 8)]
            for _ in range(cfg["model_config"]["num_layers"])]
    model.replay(params, cfg, torch.arange(3)[:, None].expand(3, 2),
                 on_layer=lambda i, refs: None)
    model.replay(params, cfg, pos, teacher=full, on_layer=keep)
    for refs, prog in zip(teacher, full):
        for r, p in zip(refs, prog):
            assert r.shape[1] == 6
            assert torch.equal(r[0, :3], p[0, :3])       # not sampled
            assert r[0, 5].abs().sum() > 0              # step 2's entry
    out = model.replay(params, cfg, pos, teacher=full)["logits"]
    assert out.shape == (1, 2, cfg["model_config"]["vocab_size"])


def test_decode_flops_by_hand():
    cfg = {"model_config": dict(
        d_model=4, num_heads=2, vocab_size=10, kv_lora_rank=3,
        qk_nope_head_dim=2, qk_rope_head_dim=1, v_head_dim=2, q_lora_rank=5,
        moe_d_ff=3, d_ff=6, num_experts=2, router_experts=8, top_k=4,
        num_shared_experts=1, num_layers=3, first_k_dense=1)}
    mla = 2 * (4 * 5 + 5 * 2 * 3 + 4 * 4 + 3 * 2 * 4 + 2 * 2 * 4)
    moe = 2 * (4 * 8 + 3 * 4 * 3 * 4 * 2 / 8 + 3 * 4 * 3)
    per_token = 3 * mla + 1 * 2 * 3 * 4 * 6 + 2 * moe + 2 * 4 * 10
    attn = sum(2 * 3 * 2 * (c + 1) * (2 + 1 + 2) for c in (0, 7))
    assert model.decode_flops(cfg, [0, 7]) == pytest.approx(
        2 * per_token + attn)


def test_wide_roofline_counts_by_hand():
    # rows at contexts 0 and 5, 2 heads, rank 3, rope 1, bf16
    want = 2 * ((1 * 4 + 2 * 4 + 2 * 3) + (6 * 4 + 2 * 4 + 2 * 3))
    assert metric.mla_decode_wide_bytes([0, 5], 2, 3, 1) == want
    assert metric.mla_decode_wide_flops([0, 5], 2, 3, 1) == \
        2.0 * 2 * 7 * (1 + 6)


def _data(traced, launches):
    its = [Iteration(rows=2, contexts=[0, 5], bucket=0, f_mhz=1980.0,
                     wall_s=0.0, dt_s=0.0),
           Iteration(rows=0, contexts=[], bucket=64, f_mhz=1980.0,
                     wall_s=0.0, dt_s=0.0)]
    cfg = {"model_config": {"num_heads": 2, "kv_lora_rank": 3,
                            "qk_rope_head_dim": 1}}
    return types.SimpleNamespace(traced=traced, config=cfg,
                                 all_iterations=its,
                                 decode_launches=launches)


def test_wide_roofline_reads_its_kernels():
    """Its three passes in the iterations with decode rows, none of the
    narrow kernel's; nothing untraced or where no launch is captured."""
    kernels = {0: [("void mla_wide_list_kernel", 0.0, 1.0),
                   ("void wide::mla_wide_tile_kernel", 1.0, 6.0),
                   ("void mla_wide_merge_kernel", 7.0, 1.0),
                   ("void mla_decode_tile_kernel<512, 64>", 8.0, 9.0)],
               1: [("void wide::mla_wide_tile_kernel", 0.0, 50.0)]}
    got = metric.read(_data(types.SimpleNamespace(kernels=kernels),
                            {"mla_decode_wide": 3}))
    shape = ([0, 5], 2, 3, 1)
    bound = 3 * peaks.bound_s(metric.mla_decode_wide_flops(*shape),
                              metric.mla_decode_wide_bytes(*shape))
    assert got == pytest.approx(100.0 * bound / 8e-6)
    assert metric.read(_data(None, {"mla_decode_wide": 3})) is None
    parent = {0: [("void mla_decode_tile_kernel<512, 64>", 0.0, 3.0)]}
    assert metric.read(_data(types.SimpleNamespace(kernels=parent),
                             {"mla_decode": 3})) is None
