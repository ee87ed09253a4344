"""deepseek-v2-lite-16b — MoE with Multi-head Latent Attention.
[arXiv:2405.04434] 27L d_model=2048 16H d_ff(expert)=1408 vocab=102400,
MLA kv_lora=512, 2 shared + 64 routed experts top-6, first layer dense FFN.

Note: the assignment line reads "MoE 64e top-6 ... 2 shared+160 routed
top-6" — internally inconsistent; we follow the primary "64e top-6"
(the V2-Lite model card: 64 routed, 2 shared, moe_intermediate=1408,
dense first-layer intermediate=10944)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,            # dense first-layer FFN (model card)
    moe_d_ff=1408,         # per-expert hidden (assignment)
    vocab_size=102400,
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    first_k_dense=1,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    ffn_activation="swiglu",
    use_rope=True,
    rope_theta=10000.0,
    source="arXiv:2405.04434",
)
