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
tensor launches the kernel or raises; a CPU or meta tensor takes the plain
version. ``flash_attention.launches`` counts the calls that launched it
(the split walk's merge kernel included in its call), and
``flash_attention.last_split`` is the key ranges of the latest launch.

Training: with grad enabled and an input that requires it, the call runs
``FlashAttention``, a ``torch.autograd.Function`` whose forward launches
K4 with its log-sum-exp output and whose backward launches K4's
backward, ``flash_attention_bwd`` (CUDA C++ for ``sm_90a``,
``csrc/flash_attention_bwd.cu``, on tensor cores in 3xTF32 as the
forward; counted in ``flash_attention_bwd.launches``). The plain backward
(``ref.flash_attention_bwd``) takes CPU tensors, as every plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_void_p]


def _check_mask(Sq, causal, window, prefix_len):
    """The mask arguments, validated; a window of at least Sq masks no
    key that the causal mask allows, so it becomes None."""
    if window is not None and (window < 1 or not causal):
        raise ValueError(f"flash_attention: window {window} must be >= 1 "
                         f"and causal")
    if prefix_len < 0:
        raise ValueError(f"flash_attention: prefix_len {prefix_len} must "
                         f"be >= 0")
    return None if window is not None and window >= Sq else window


def flash_attention(q, k, v, scale=None, causal=True, window=None,
                    prefix_len=0):
    """q (B, Sq, H, D); k/v (B, Sk, Hkv, D), H a multiple of Hkv;
    ``window`` None or a positive int: query t attends keys
    t-window+1..t (causal only). A window of at least Sq masks no key
    that the causal mask allows, so it is dropped and the causal walk
    runs. ``prefix_len`` >= 0: keys below it are visible to every query
    as well (a prefix-LM; 0 for none). Returns (B, Sq, H, D) in q's
    dtype. With grad enabled and an input that requires it, the call
    goes through ``FlashAttention``, whose backward is
    ``flash_attention_bwd``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    window = _check_mask(q.shape[1], causal, window, prefix_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, scale, causal, window,
                                    prefix_len)
    return _forward(q, k, v, scale, causal, window, prefix_len, False)[0]


def _forward(q, k, v, scale, causal, window, prefix_len, want_lse):
    """(out, lse or None): the kernel on a CUDA tensor, the plain version
    on a CPU or meta one; ``lse`` (B, Sq, H) fp32 is each row's log-sum-exp."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if q.device.type in _build.PLAIN_DEVICES:
        if want_lse:
            return ref.flash_attention(q, k, v, scale, causal, window,
                                       prefix_len, return_lse=True)
        return ref.flash_attention(q, k, v, scale, causal, window,
                                   prefix_len), None
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    qc, kc = _build.check_dense_args("flash_attention", q, k, v, (),
                                     q_rank=4)
    if q.data_ptr() % 16:
        raise ValueError("flash_attention: q must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = (torch.empty(B, Sq, H, dtype=torch.float32, device=q.device)
           if want_lse else None)
    if B == 0 or Sq == 0:
        return out, lse
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
            part_ml.data_ptr() if part_ml is not None else None,
            lse.data_ptr() if lse is not None else None, n_split,
            B, Sq, Sk, H, Hkv, D, int(bool(causal)), int(window or 0),
            int(prefix_len), float(scale), qc, kc,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    flash_attention.launches += 1
    flash_attention.last_split = n_split
    return out, lse


flash_attention.launches = 0
flash_attention.last_split = None


def flash_attention_bwd(q, k, v, o, lse, do, scale, causal=True,
                        window=None, prefix_len=0):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, scale,
    causal, window, prefix_len)`` whose output was ``o`` (B, Sq, H, D) and
    log-sum-exp ``lse`` (B, Sq, H), for the output gradient ``do``. On a
    CUDA tensor the hand-written backward (``csrc/flash_attention_bwd.cu``:
    D = sum_j P_ij dP_ij in a pass over the keys, then dK/dV and dQ, with
    every product on the tensor cores in 3xTF32, no atomics; ``o`` is
    checked but not read; its launches counted as one in
    ``flash_attention_bwd.launches``) on fp32 q/k/v/o/do, each kv head's
    query heads split across dK/dV blocks where the grid is short of two
    blocks an SM (``bwd_split``; ``flash_attention_bwd.last_split``); on a
    CPU or meta tensor its plain version, ``ref.flash_attention_bwd``."""
    window = _check_mask(q.shape[1], causal, window, prefix_len)
    if q.device.type in _build.PLAIN_DEVICES:
        return ref.flash_attention_bwd(q, k, v, o, lse, do, scale, causal,
                                       window, prefix_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device "
                         f"{q.device}")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    ts = (q, k, v, o, lse, do)
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_attention_bwd: all tensors must share q's "
                         "device")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("flash_attention_bwd: q, k, v, o, lse and do must "
                         "be float32")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("flash_attention_bwd: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash_attention_bwd: q, k, v and do must be "
                         "16-byte aligned")
    if k.shape != (B, Sk, Hkv, D) or v.shape != k.shape or o.shape != \
            q.shape or do.shape != q.shape or lse.shape != (B, Sq, H) \
            or H % Hkv:
        raise ValueError(f"flash_attention_bwd: bad shapes q "
                         f"{tuple(q.shape)}, k/v {tuple(k.shape)}")
    if D not in _build.HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {D} not in "
                         f"{_build.HEAD_DIMS}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B * Sq * Sk * H == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dsum = torch.empty(B, Sq, H, dtype=torch.float32, device=q.device)
    n_split = bwd_split(_bwd_blocks(D, B, Sk, Hkv), H // Hkv,
                        _build.sm_count(q.device.index or 0))
    parts = ([torch.empty(n_split, *k.shape, dtype=torch.float32,
                          device=q.device) for _ in range(2)]
             if n_split > 1 else [None, None])
    fn = _build.load_entry("flash_attention_bwd",
                           "flash_attention_bwd_launch", _BWD_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dsum.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in parts),
            n_split, B, Sq, Sk, H, Hkv, D, int(bool(causal)),
            int(window or 0), int(prefix_len), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError "
                           f"{rc}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.last_split = n_split
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.last_split = None


def bwd_split(blocks, G, sms):
    """Groups each kv head's G query heads are split into across dK/dV
    blocks, for a grid of ``blocks`` a group: 1 where that already gives
    two blocks an SM, else enough groups for that, at most G (a head a
    block), each of ceil(G / groups) heads and none empty."""
    target = 2 * sms
    if blocks >= target:
        return 1
    per = -(-G // min(G, -(-target // blocks)))
    return -(-G // per)


@functools.lru_cache(maxsize=256)
def _bwd_blocks(D, B, Sk, Hkv):
    """The backward's dK/dV blocks of one head group at these shapes, from
    its launcher's own grid (``flash_attention_bwd_grid``)."""
    out = (ctypes.c_int * 1)()
    fn = _build.load_entry("flash_attention_bwd", "flash_attention_bwd_grid",
                           [ctypes.c_int] * 4
                           + [ctypes.POINTER(ctypes.c_int)])
    rc = fn(D, B, Sk, Hkv, out)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_grid failed: cudaError {rc}")
    return out[0]


class FlashAttention(torch.autograd.Function):
    """K4 under autograd: the forward launches K4 with its ``lse`` output
    and saves q, k, v, the output and ``lse``; the backward launches
    ``flash_attention_bwd`` (the plain versions on CPU tensors, so that
    the CPU tests drive this same Function). A bf16 input is widened to
    fp32 for the backward kernel and its gradient narrowed back."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, prefix_len):
        out, lse = _forward(q, k, v, scale, causal, window, prefix_len,
                            True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (scale, causal, window, prefix_len)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            do = do.float().contiguous()
            if do.data_ptr() % 16:      # a view at an odd offset
                do = do.clone()
            grads = flash_attention_bwd(
                *(t.float().contiguous() for t in (q, k, v, out)), lse, do,
                *ctx.mask)
            grads = [g.to(t.dtype) for g, t in zip(grads, (q, k, v))]
        else:
            grads = flash_attention_bwd(q, k, v, out, lse, do, *ctx.mask)
        return (*grads, None, None, None, None)
