"""mamba2-1.3b — attention-free SSM with SSD (state-space duality).
[arXiv:2405.21060] 48L d_model=2048 vocab=50280, d_state=128, expand=2,
head_dim=64 (=> 64 ssm heads), ngroups=1. Constant state => long_500k
native sub-quadratic."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,          # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=128,
    conv_kernel=4,
    tie_embeddings=True,
    use_rope=False,
    source="arXiv:2405.21060",
)
