"""starcoder2-7b — dense GQA + RoPE; model-card sliding window 4096 is the
sub-quadratic variant used for long_500k. [arXiv:2402.19173]
32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    ffn_activation="gelu",
    use_rope=True,
    rope_theta=100000.0,
    source="arXiv:2402.19173",
)
# sliding-window value used when long_500k requests the sub-quadratic variant
LONG_CONTEXT_WINDOW = 4096
