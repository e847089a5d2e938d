"""kimi-k2-1t-a32b — trillion-param MoE [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8), per-expert d_ff=2048, 384 experts top-8,
1 shared expert, first layer dense (d_ff=18432), vocab=163840."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,          # dense (first) layer MLP
    vocab_size=163840,
    num_experts=384,
    num_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_dense_layers=1,
    rope_theta=5.0e4,
    source="Kimi K2 [arXiv:2501.kimi2] (paper-table)",
)
