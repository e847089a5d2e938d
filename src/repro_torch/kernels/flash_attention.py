"""Causal (or full) GQA prefill attention: every query token of a row
attends that row's keys, causal masking aligned at the top left, with an
optional local-attention window (recurrentgemma-9b's attention layers)
and an optional prefix-LM prefix that every query attends
(paligemma-3b's image tokens).

Port of ``repro/kernels/flash_attention.py`` at the shapes of its
wrapper ``repro/kernels/ops.py::flash_attention``: q (B, Sq, H, D), k/v
(B, Sk, Hkv, D), read in place with no transposes. The kernel is
hand-written CUDA C++ for ``sm_90a`` (``csrc/flash_attention.cu``, whose
head note says what bounds it and how the design answers) and runs every
``Sq``/``Sk``, on tensor cores; where a prompt is short, the walk of each
q tile is split across blocks and merged in a fixed order (scratch from
``torch.empty``). ``kernels/ref.py`` holds the plain version. A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain
version. ``flash_attention.launches`` counts the calls that launched it
(the split walk's merge kernel included in its call), and
``flash_attention.last_split`` is the key ranges of the latest launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def flash_attention(q, k, v, scale=None, causal=True, window=None,
                    prefix_len=0):
    """q (B, Sq, H, D); k/v (B, Sk, Hkv, D), H a multiple of Hkv;
    ``window`` None or a positive int: query t attends keys
    t-window+1..t (causal only). A window of at least Sq masks no key
    that the causal mask allows, so it is dropped and the causal walk
    runs. ``prefix_len`` >= 0: keys below it are visible to every query
    as well (a prefix-LM; 0 for none). Returns (B, Sq, H, D) in q's
    dtype."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    if window is not None and (window < 1 or not causal):
        raise ValueError(f"flash_attention: window {window} must be >= 1 "
                         f"and causal")
    if prefix_len < 0:
        raise ValueError(f"flash_attention: prefix_len {prefix_len} must "
                         f"be >= 0")
    if window is not None and window >= Sq:
        window = None
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, scale, causal, window,
                                   prefix_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    qc, kc = _build.check_dense_args("flash_attention", q, k, v, (),
                                     q_rank=4)
    if q.data_ptr() % 16:
        raise ValueError("flash_attention: q must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    # the longest walk: a causal q tile reaches min(Sq, Sk) keys, a
    # windowed one its window and its own tile's tokens, and with a prefix
    # every tile walks from key 0 to at least the prefix
    blocks, tokens = _build.prefill_grid("flash_attention", B, Sq, H, Hkv)
    walk = min(Sq, Sk) if causal else Sk
    if window and not prefix_len:
        walk = min(walk, window + tokens)
    walk = max(walk, min(prefix_len, Sk))
    n_split = _build.prefill_split(blocks, walk,
                                   _build.sm_count(q.device.index or 0))
    part_o, part_ml = _build.split_scratch(n_split, q)
    fn = _build.load_entry("flash_attention", "flash_attention_launch",
                           _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            part_o.data_ptr() if part_o is not None else None,
            part_ml.data_ptr() if part_ml is not None else None, n_split,
            B, Sq, Sk, H, Hkv, D, int(bool(causal)), int(window or 0),
            int(prefix_len), float(scale), qc, kc,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    flash_attention.launches += 1
    flash_attention.last_split = n_split
    return out


flash_attention.launches = 0
flash_attention.last_split = None
