"""qwen3-4b — dense, qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1.0e6,
    tie_embeddings=True,
    source="[hf:Qwen/Qwen3-8B family, 4B scale]",
)
