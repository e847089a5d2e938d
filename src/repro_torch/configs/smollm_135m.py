"""smollm-135m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    source="[hf:HuggingFaceTB/SmolLM-135M]",
)
