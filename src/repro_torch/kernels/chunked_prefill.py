"""Chunked-prefill GQA attention: a page-aligned chunk of T tokens per row
attends causally over ALL prior context (earlier pages + the chunk itself)
gathered through a per-row block table over a shared page pool.

Port of ``repro/kernels/chunked_prefill.py``. The kernel is hand-written
CUDA C++ for ``sm_90a`` (``csrc/chunked_prefill.cu``, whose head note says
what bounds it and how the design answers); ``kernels/ref.py`` holds the
plain version. A CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain version. ``chunked_prefill_attention.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def chunked_prefill_attention(q, k_pages, v_pages, block_table, start_pos,
                              scale=None):
    """q (B, T, H, D) — T fresh tokens per row, token t at absolute
    position ``start_pos[b] + t``; k_pages/v_pages (P, page_size, Hkv, D)
    shared pool ALREADY holding the chunk's own K/V; block_table (B, N)
    int32 physical page ids covering positions [0, start+T); start_pos
    (B,) int32. Returns (B, T, H, D) in q's dtype.

    Rows are independent: pad rows point at the scratch page and their
    masked positions contribute exact zeros."""
    B, T, H, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    N = block_table.shape[1]
    scale = scale if scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return ref.chunked_prefill_attention(q, k_pages, v_pages,
                                             block_table, start_pos, scale)
    if q.device.type != "cuda":
        raise ValueError(f"chunked_prefill_attention: no kernel for device "
                         f"{q.device}")
    qc, kc = _build.check_paged_args(q, k_pages, v_pages, block_table,
                                     start_pos, q_rank=4)
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    fn = _build.load_entry("chunked_prefill",
                           "chunked_prefill_attention_launch", _ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), start_pos.data_ptr(), out.data_ptr(),
            B, T, H, Hkv, D, ps, N, float(scale), qc, kc,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chunked_prefill_attention launch failed: "
                           f"cudaError {rc}")
    chunked_prefill_attention.launches += 1
    return out


chunked_prefill_attention.launches = 0
