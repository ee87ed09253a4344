"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention, 1:2.
[arXiv:2402.19427] 38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000,
lru_width=4096, local window 2048, pattern (rec, rec, attn).
38 = 12*(rec,rec,attn) + 2 trailing rec layers (38 % 3 != 0; see DESIGN.md).
Bounded state => long_500k native."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    local_window=2048,
    ffn_activation="geglu",
    use_rope=True,
    source="arXiv:2402.19427",
)
