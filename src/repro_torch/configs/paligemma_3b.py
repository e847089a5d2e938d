"""paligemma-3b — SigLIP + gemma decoder [arXiv:2407.07726].

Backbone only: the SigLIP vision tower + projector is a stub providing
precomputed patch embeddings (256 tokens) consumed with a prefix-LM mask."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    frontend="vision",
    num_prefix_tokens=256,
    prefix_lm=True,
    tie_embeddings=True,
    source="PaliGemma [arXiv:2407.07726]",
)
