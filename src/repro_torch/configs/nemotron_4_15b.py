"""nemotron-4-15b — dense, GQA, squared-ReLU (ungated) FFN.
[arXiv:2402.16819] 32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    ffn_activation="squared_relu",
    use_rope=True,
    source="arXiv:2402.16819",
)
