"""Causal (or full) GQA prefill attention: every query token of a row
attends that row's keys, causal masking aligned at the top left.

Port of ``repro/kernels/flash_attention.py`` at the shapes of its
wrapper ``repro/kernels/ops.py::flash_attention``: q (B, Sq, H, D), k/v
(B, Sk, Hkv, D), read in place with no transposes. The kernel is
hand-written CUDA C++ for ``sm_90a`` (``csrc/flash_attention.cu``, whose
head note says what bounds it and how the design answers) and runs every
``Sq``/``Sk``; ``kernels/ref.py`` holds the plain version. A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain version.
``flash_attention.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def flash_attention(q, k, v, scale=None, causal=True):
    """q (B, Sq, H, D); k/v (B, Sk, Hkv, D), H a multiple of Hkv.
    Returns (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    qc, kc = _build.check_dense_args("flash_attention", q, k, v, (),
                                     q_rank=4)
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    fn = _build.load_entry("flash_attention", "flash_attention_launch",
                           _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, Hkv, D, int(bool(causal)), float(scale), qc, kc,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
