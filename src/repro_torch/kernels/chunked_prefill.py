"""Chunked-prefill GQA attention: a page-aligned chunk of T tokens per row
attends causally over ALL prior context (earlier pages + the chunk itself)
gathered through a per-row block table over a shared page pool.

Port of ``repro/kernels/chunked_prefill.py``. The kernel is hand-written
CUDA C++ for ``sm_90a`` (``csrc/chunked_prefill.cu``, whose head note says
what bounds it and how the design answers) on tensor cores; where a
tick's rows give the card too few blocks, each q tile's key walk is split
across blocks and merged in a fixed order (scratch from ``torch.empty``).
``kernels/ref.py`` holds the plain version. A CUDA tensor launches the
kernel or raises; a CPU or meta tensor takes the plain version.
``chunked_prefill_attention.launches`` counts the calls that launched it,
and ``chunked_prefill_attention.last_split`` is the key ranges of the
latest launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
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
    if q.device.type in _build.PLAIN_DEVICES:
        return ref.chunked_prefill_attention(q, k_pages, v_pages,
                                             block_table, start_pos, scale)
    if q.device.type != "cuda":
        raise ValueError(f"chunked_prefill_attention: no kernel for device "
                         f"{q.device}")
    _build.refuse_grad("chunked_prefill_attention", (q, k_pages, v_pages),
                       "no training path differentiates it")
    qc, kc = _build.check_paged_args(q, k_pages, v_pages, block_table,
                                     start_pos, q_rank=4)
    if q.data_ptr() % 16:
        raise ValueError("chunked_prefill_attention: q must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    # the longest walk is at most the table's N pages: the starts stay on
    # the device
    blocks, _ = _build.prefill_grid("chunked_prefill", B, T, H, Hkv)
    n_split = _build.prefill_split(blocks, N * ps,
                                   _build.sm_count(q.device.index or 0))
    part_o, part_ml = _build.split_scratch(n_split, q)
    fn = _build.load_entry("chunked_prefill",
                           "chunked_prefill_attention_launch", _ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), start_pos.data_ptr(), out.data_ptr(),
            part_o.data_ptr() if part_o is not None else None,
            part_ml.data_ptr() if part_ml is not None else None, n_split,
            B, T, H, Hkv, D, ps, N, float(scale), qc, kc,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chunked_prefill_attention launch failed: "
                           f"cudaError {rc}")
    chunked_prefill_attention.launches += 1
    chunked_prefill_attention.last_split = n_split
    return out


chunked_prefill_attention.launches = 0
chunked_prefill_attention.last_split = None
