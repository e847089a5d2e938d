"""Config system: model configs, input shapes, and the architecture registry.

Every assigned architecture gets one module in this package defining
``CONFIG`` (the exact full-size config, citing its source) and registering it
under its ``--arch`` id. ``ModelConfig.reduced()`` derives the CPU-smoke
variant (2 layers, d_model<=512, <=4 experts) used by per-arch smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    source: str = ""  # citation for the config

    # attention options
    qk_norm: bool = False
    rope_theta: float = 1.0e4
    attn_window: Optional[int] = None  # sliding/local attention window
    # per-layer block pattern, cycled over depth, e.g. ("rglru","rglru","attn")
    pattern: tuple = ("attn",)
    prefix_lm: bool = False  # bidirectional attention over prefix (VLM)

    # MLA (multi-head latent attention, DeepSeek-V2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0  # 0 = no q compression
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # RG-LRU (Griffin / RecurrentGemma)
    lru_width: int = 0
    # gate matrices: 0 = dense (lru x lru); n = block-diagonal with n blocks
    # (Griffin's actual structure; also keeps the gates shard-local)
    lru_diag_blocks: int = 0

    # modality frontend stub ("audio" | "vision" | None)
    frontend: Optional[str] = None
    num_prefix_tokens: int = 0

    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # which impls support 512k decode sub-quadratically natively
    # (dense archs get the beyond-paper sliding-window decode variant)
    subquadratic: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim if self.ssm_state else 0

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: 2 layers, d_model<=512,
        <=4 experts, small vocab."""
        d_model = min(self.d_model, 256)
        head_dim = 32
        num_heads = max(2, min(4, self.num_heads))
        num_kv_heads = max(1, min(num_heads, self.num_kv_heads))
        # keep kv | heads divisibility
        while num_heads % num_kv_heads:
            num_kv_heads -= 1
        n_layers = max(2, len(self.pattern)) if len(self.pattern) > 1 else 2
        changes = dict(
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv_heads,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            attn_window=min(self.attn_window, 64) if self.attn_window else None,
            num_prefix_tokens=min(self.num_prefix_tokens, 8) if self.num_prefix_tokens else 0,
        )
        if self.num_experts:
            changes.update(
                num_experts=4,
                top_k=min(2, self.top_k),
                moe_d_ff=min(self.moe_d_ff, 128),
                num_shared_experts=min(1, self.num_shared_experts),
                first_dense_layers=min(1, self.first_dense_layers),
            )
        if self.use_mla:
            changes.update(kv_lora_rank=64, q_lora_rank=0, rope_head_dim=16,
                           nope_head_dim=32, v_head_dim=32)
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.lru_width:
            changes.update(lru_width=d_model,
                           lru_diag_blocks=min(4, self.lru_diag_blocks)
                           if self.lru_diag_blocks else 0)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "mamba2-370m",
    "glm4-9b",
    "qwen3-32b",
    "kimi-k2-1t-a32b",
    "recurrentgemma-9b",
    "musicgen-large",
    "deepseek-v2-lite-16b",
    "smollm-135m",
    "qwen3-4b",
    "paligemma-3b",
]

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
