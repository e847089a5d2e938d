"""Paged GQA decode attention: ONE query token per sequence, K/V gathered
through a per-sequence block table over a shared page pool.

Port of ``repro/kernels/paged_attention.py``. The kernel is hand-written
CUDA C++ for ``sm_90a`` (``csrc/paged_attention.cu``, whose head note says
what bounds it and how the design answers) on tensor cores; where the
decode batch gives the card too few blocks, each sequence's key walk is
split across blocks and merged in a fixed order (scratch from
``torch.empty``). ``kernels/ref.py`` holds the plain version. A CUDA
tensor launches the kernel or raises; a CPU or meta tensor takes the plain
version. ``paged_decode_attention.launches`` counts the calls that
launched it (the split walk's merge kernel included in its call), and
``paged_decode_attention.last_split`` is the key ranges of the latest
launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def paged_decode_attention(q, k_pages, v_pages, block_table, valid_lens,
                           scale=None):
    """q (B, H, D) one token per sequence; k_pages/v_pages
    (P, page_size, Hkv, D) shared pool; block_table (B, N) int32 physical
    page ids; valid_lens (B,) int32 filled tokens per sequence.
    Returns (B, H, D) in q's dtype."""
    B, H, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    N = block_table.shape[1]
    scale = scale if scale is not None else D ** -0.5
    if q.device.type in _build.PLAIN_DEVICES:
        return ref.paged_decode_attention(q, k_pages, v_pages, block_table,
                                          valid_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    _build.refuse_grad("paged_decode_attention", (q, k_pages, v_pages),
                       "no training path differentiates it")
    qc, kc = _build.check_paged_args(q, k_pages, v_pages, block_table,
                                     valid_lens, q_rank=3)
    out = torch.empty_like(q)
    if B == 0:
        return out
    # the split comes from the shapes: the fills stay on the device, and
    # the longest walk is at most the table's N pages
    *_, tile, blocks = _build.decode_attrs(
        "paged_attention", "paged_decode_attention_attrs", qc, kc, D, B, H,
        Hkv)
    n_split = _build.prefill_split(blocks, N * ps,
                                   _build.sm_count(q.device.index or 0),
                                   tile)
    part_o, part_ml = _build.split_scratch(n_split, q)
    fn = _build.load_entry("paged_attention", "paged_decode_attention_launch",
                           _ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), valid_lens.data_ptr(), out.data_ptr(),
            part_o.data_ptr() if part_o is not None else None,
            part_ml.data_ptr() if part_ml is not None else None, n_split,
            B, H, Hkv, D, ps, N, float(scale), qc, kc,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"cudaError {rc}")
    paged_decode_attention.launches += 1
    paged_decode_attention.last_split = n_split
    return out


paged_decode_attention.launches = 0
paged_decode_attention.last_split = None
