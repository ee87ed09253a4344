"""tinyllama-1.1b — llama2-architecture small model. [arXiv:2401.02385]
22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    ffn_activation="swiglu",
    use_rope=True,
    source="arXiv:2401.02385",
)
