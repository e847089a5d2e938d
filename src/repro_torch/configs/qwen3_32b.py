"""qwen3-32b — dense, qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1.0e6,
    source="[hf:Qwen/Qwen3-8B family, 32B scale]",
)
