"""recurrentgemma-9b — RG-LRU + local attention, 1 attn per 3 blocks
[arXiv:2402.19427 Griffin / RecurrentGemma]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    pattern=("rglru", "rglru", "attn"),
    attn_window=2048,
    lru_width=4096,
    lru_diag_blocks=16,   # Griffin's block-diagonal recurrence gates
    conv_width=4,
    tie_embeddings=True,
    subquadratic=True,
    source="RG-LRU + local attn 1:2 [arXiv:2402.19427]",
)
