"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

Backbone only: the EnCodec/mel frontend is a stub providing precomputed
frame embeddings (see input_specs)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio",
    source="MusicGen [arXiv:2306.05284]",
)
