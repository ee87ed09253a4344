"""llama3-3b — the paper's own evaluation model (AGFT §5.1 uses
"Llama-3-3B"; dims per Llama-3.2-3B model card).
28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-3b",
    arch_type="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    ffn_activation="swiglu",
    use_rope=True,
    rope_theta=500000.0,
    source="paper §5.1 / hf:meta-llama/Llama-3.2-3B",
)
