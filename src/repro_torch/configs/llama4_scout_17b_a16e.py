"""llama4-scout-17b-a16e — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 16 experts top-1 (+1 shared, per model card)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    moe_d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    top_k=1,
    num_shared_experts=1,
    ffn_activation="swiglu",
    use_rope=True,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
