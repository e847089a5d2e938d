"""deepseek-v2-lite-16b — MLA kv_lora=512, MoE 64e top-6 + 2 shared
[arXiv:2405.04434]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,    # MLA: heads share one latent; kept for bookkeeping
    head_dim=128,
    d_ff=10944,         # dense (first) layer MLP
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,      # V2-Lite has no q compression
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    source="DeepSeek-V2-Lite [arXiv:2405.04434]",
)
