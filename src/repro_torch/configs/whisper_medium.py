"""whisper-medium — encoder-decoder audio backbone; conv/mel frontend STUB
(input_specs provides (B, 1500, d_model) frame embeddings).
[arXiv:2212.04356] 24+24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="encdec",
    is_encoder_decoder=True,
    num_layers=24,
    encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    ffn_activation="gelu",
    use_rope=False,
    frontend_stub="audio_frames",
    source="arXiv:2212.04356",
)
