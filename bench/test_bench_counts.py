"""The counts of operations and bytes that the per-layer metrics hold
kernels and steps to, against hand counts at a tiny configuration."""
import pytest

from bench import counts, peaks
from bench.cell import load_cell


def test_rmsnorm_bytes_by_hand():
    # 8 rows of 16 bf16: x in, y out, weight in (2 bytes each)
    assert counts.rmsnorm_bytes(8, 16, False) == 2 * (8 * 16 * 2) + 32
    # fused: x, r in; sum, y out
    assert counts.rmsnorm_bytes(8, 16, True) == 4 * (8 * 16 * 2) + 32


def test_ssd_scan_cost_by_hand():
    flops, nbytes = counts.ssd_scan_cost(tokens=2, heads=3, head_dim=4,
                                         groups=1, state=5)
    assert flops == 5 * 2 * 3 * 4 * 5
    x = y = 2 * 3 * 4
    dt, A, B, C, state = 2 * 3, 3, 2 * 5, 2 * 5, 3 * 4 * 5
    assert nbytes == 4 * (x + y + dt + A + B + C + state)


def test_bound_takes_the_larger():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 1.0, "fp32") == pytest.approx(1.0)


def _tiny(name, **sizes):
    cell = load_cell(name)
    cell.config["model_config"].update(sizes)
    return cell


def test_deepseek_decode_flops_by_hand():
    cell = _tiny("deepseek-v2-lite-16b.normal", num_layers=2,
                 first_k_dense=1, d_model=4, num_heads=2, vocab_size=10,
                 kv_lora_rank=3, qk_nope_head_dim=2, qk_rope_head_dim=2,
                 v_head_dim=2, num_experts=4, top_k=2, num_shared_experts=1,
                 moe_d_ff=3, d_ff=5)
    # MLA a layer: wq 4x(2*4) + w_dkv 4x(3+2) + w_uk, w_uv 3x(2*2) each
    # + wo (2*2)x4, two flops a multiply-add
    mla = 2 * (4 * 8 + 4 * 5 + 3 * 4 + 3 * 4 + 4 * 4)
    dense = 2 * 3 * 4 * 5                       # gate, up, down
    moe = 2 * (4 * 4 + 2 * 3 * 4 * 3 + 3 * 4 * 3)   # router, 2 experts, shared
    head = 2 * 4 * 10
    per_token = 2 * mla + dense + moe + head
    # attention at context c: 2 layers x 2 heads x (c + 1) keys x
    # (nope + rope for the scores + v for the values) x 2
    attn = sum(2 * 2 * 2 * (c + 1) * (2 + 2 + 2) for c in (0, 5))
    assert cell.model.decode_flops(cell.config, [0, 5]) == \
        2 * per_token + attn


def test_mamba2_decode_flops_by_hand():
    cell = _tiny("mamba2-1.3b.chat", num_layers=1, d_model=4, vocab_size=10,
                 ssm_state=3, ssm_head_dim=2, ssm_expand=2, ssm_ngroups=1,
                 conv_kernel=4)
    d_in, H, N = 8, 4, 3
    conv = d_in + 2 * N
    layer = (2 * 4 * (2 * d_in + 2 * N + H) + 2 * 4 * conv
             + 5 * H * 2 * N + 2 * d_in * 4)
    assert cell.model.decode_flops(cell.config, [7, 9, 11]) == \
        3 * (layer + 2 * 4 * 10)
