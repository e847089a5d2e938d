"""Dense-cache GQA decode attention: ONE query token per row against a
(B, S, Hkv, D) K/V cache, of which each row's first ``valid_len`` slots
are filled.

Port of ``repro/kernels/decode_attention.py``. The kernel is hand-written
CUDA C++ for ``sm_90a`` (``csrc/decode_attention.cu``, whose head note
says what bounds it and how the design answers) on tensor cores; where the
rows give the card too few blocks, each row's key walk is split across
blocks and merged in a fixed order (scratch from ``torch.empty``).
``kernels/ref.py`` holds the plain version. A CUDA tensor launches the
kernel or raises; a CPU or meta tensor takes the plain version.
``decode_attention.launches`` counts the calls that launched it (the
split walk's merge kernel included in its call), and
``decode_attention.last_split`` is the key ranges of the latest launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def decode_attention(q, k, v, valid_len, scale=None):
    """q (B, H, D) one token per row; k/v (B, S, Hkv, D); valid_len a
    scalar or a (B,) int32 tensor of filled slots per row (the stacked
    batcher gives every slot its own). Returns (B, H, D) in q's dtype."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    if q.device.type in _build.PLAIN_DEVICES:
        return ref.decode_attention(q, k, v, valid_len, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device "
                         f"{q.device}")
    _build.refuse_grad("decode_attention", (q, k, v),
                       "no training path differentiates it")
    lens = torch.as_tensor(valid_len, device=q.device)
    if lens.dim() == 0:
        lens = lens.to(torch.int32).expand(B).contiguous()
    qc, kc = _build.check_dense_args("decode_attention", q, k, v, (lens,),
                                     q_rank=3)
    if lens.shape != (B,):
        raise ValueError(f"decode_attention: valid_len {tuple(lens.shape)} "
                         f"does not match batch {B}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    # the split comes from the shapes: the fills stay on the device, and
    # the longest walk is at most the cache's S slots
    *_, tile, blocks = _build.decode_attrs(
        "decode_attention", "decode_attention_attrs", qc, kc, D, B, H, Hkv)
    n_split = _build.prefill_split(blocks, S,
                                   _build.sm_count(q.device.index or 0),
                                   tile)
    part_o, part_ml = _build.split_scratch(n_split, q)
    fn = _build.load_entry("decode_attention", "decode_attention_launch",
                           _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            out.data_ptr(),
            part_o.data_ptr() if part_o is not None else None,
            part_ml.data_ptr() if part_ml is not None else None, n_split,
            B, H, Hkv, D, S, float(scale), qc, kc,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {rc}")
    decode_attention.launches += 1
    decode_attention.last_split = n_split
    return out


decode_attention.launches = 0
decode_attention.last_split = None
