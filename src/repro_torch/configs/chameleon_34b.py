"""chameleon-34b — early-fusion VLM: VQ image tokens share the text vocab,
so the backbone is a dense decoder with QK-norm. [arXiv:2405.09818]
48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (incl. VQ codes).
The VQ-VAE image tokenizer is a STUB: input_specs provides token ids."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    use_qk_norm=True,
    ffn_activation="swiglu",
    use_rope=True,
    frontend_stub="vq_image_tokens",
    source="arXiv:2405.09818",
)
