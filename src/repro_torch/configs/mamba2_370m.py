"""mamba2-370m — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024, attn-free, vocab=50280, ssm_state=128. d_ff=0 (the Mamba-2
block contains its own 2x expansion; there is no separate MLP)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    pattern=("ssm",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
    subquadratic=True,
    source="SSD / Mamba-2 [arXiv:2405.21060]",
)
