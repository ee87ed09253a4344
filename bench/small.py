"""Small copies of the benchmark's cells for the CPU tests: the same
families, mixes and limits at a few dozen of the widths, a few rows."""
from __future__ import annotations

from bench.cell import load_cell

SIZES = {
    "moe": dict(num_layers=3, d_model=64, num_heads=2, num_kv_heads=2,
                head_dim=16, d_ff=96, vocab_size=128, num_experts=4,
                top_k=2, num_shared_experts=1, moe_d_ff=32, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    "ssm": dict(num_layers=2, d_model=64, vocab_size=128, ssm_state=16,
                ssm_head_dim=16, ssm_chunk=16),
}


#: the depth at which the fp8 control's error, which grows with depth,
#: passes limits set for the whole depth of the cell's model
CONTROL_LAYERS = {"ssm": 16}


def small_cell(name: str, control: bool = False):
    cell = load_cell(name)
    m = cell.config["model_config"]
    m.update(SIZES[m["arch_type"]])
    if control and m["arch_type"] in CONTROL_LAYERS:
        m["num_layers"] = CONTROL_LAYERS[m["arch_type"]]
    t = cell.traffic
    t.update(max_batch=4, cache_len=64, warmup_iterations=5)
    if t["loop"] == "closed":
        t.update(clients=4, prompt={"dist": "uniform", "lo": 8, "hi": 40},
                 output={"dist": "uniform", "lo": 4, "hi": 20})
    else:
        t.update(rate_per_s=5.0, requests=400)
    return cell
