"""Abstract stand-ins for every model input (no device allocation).

Port of ``repro/launch/specs.py``, with meta-device tensors in place of
``jax.ShapeDtypeStruct``: each has the input's shape and dtype and no
storage. ``input_specs(cfg, shape)`` returns the abstract inputs for the
step function that the given input shape lowers: train_step for training
shapes, prefill_step for prefill, serve_step (ONE token + KV/state cache)
for decode shapes. Modality frontends are stubbed here: audio/vision
configs get precomputed frame/patch embeddings of the right shape.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig

# beyond-paper variant: ring-buffer sliding-window decode for full-attention
# archs at 524k context (natively sub-quadratic archs don't need it)
SLIDING_WINDOW = 8192
LONG_SEQ = 524288


def abstract(shape, dtype) -> torch.Tensor:
    """A meta tensor: shape and dtype, no storage."""
    return torch.empty(shape, dtype=dtype, device="meta")


def needs_sliding_window(cfg: ModelConfig, shape: InputShape) -> bool:
    return (shape.kind == "decode" and shape.seq_len >= LONG_SEQ
            and not cfg.subquadratic)


def decode_window(cfg: ModelConfig, shape: InputShape):
    """Ring-buffer window to use for decode, or None for full cache."""
    if needs_sliding_window(cfg, shape):
        return SLIDING_WINDOW
    return cfg.attn_window  # hybrid local attention windows apply always


def batch_inputs(cfg: ModelConfig, batch: int, seq: int):
    """Abstract full-sequence inputs (train/prefill)."""
    emb_dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "audio":
        return {"embeddings": abstract((batch, seq, cfg.d_model), emb_dt)}
    if cfg.frontend == "vision":
        P = cfg.num_prefix_tokens
        return {"embeddings": abstract((batch, P, cfg.d_model), emb_dt),
                "tokens": abstract((batch, seq - P), torch.int32)}
    return {"tokens": abstract((batch, seq), torch.int32)}


def label_len(cfg: ModelConfig, seq: int) -> int:
    if cfg.frontend == "audio":
        return seq
    if cfg.frontend == "vision":
        return seq - cfg.num_prefix_tokens
    return seq


def input_specs(cfg: ModelConfig, shape: InputShape):
    """Returns (kind, inputs dict of meta tensors)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        inp = batch_inputs(cfg, B, S)
        inp["labels"] = abstract((B, label_len(cfg, S)), torch.int32)
        return "train", inp
    if shape.kind == "prefill":
        return "prefill", batch_inputs(cfg, B, S)
    # decode: ONE new token at position S against a cache of size S
    return "decode", {"token": abstract((B, 1), torch.int32),
                      "pos": abstract((), torch.int32)}


def input_axes(cfg: ModelConfig, shape: InputShape):
    """Logical axes for the abstract inputs (leading batch dim sharded)."""
    kind, inp = input_specs(cfg, shape)
    axes = {}
    for k, v in inp.items():
        if v.ndim == 0:
            axes[k] = ()
        else:
            axes[k] = ("batch",) + (None,) * (v.ndim - 1)
    return kind, axes
