"""The RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t along the
sequence, from an optional h0.

Port of ``repro/kernels/rglru.py::rglru_scan`` (wrapper
``repro/kernels/ops.py:83``) with its signature and layouts: a, b
(B, S, C) fp32 or bf16, h0 (B, C) or None, h (B, S, C) fp32; every S and
every C (the Pallas kernel's ``S % 256`` and ``C % 512`` asserts are its
tiling). The kernel is hand-written CUDA C++ for ``sm_90a``
(``csrc/rglru_scan.cu``, whose head note says what bounds it and how the
design answers: a lane a channel, fed from a deep cp.async ring);
``kernels/ref.py`` holds the plain version, which the
kernel matches bit for bit. A CUDA tensor launches the kernel or raises;
a CPU or meta tensor takes the plain version. ``rglru_scan.launches``
counts the kernel launches.

Training: with grad enabled and an input that requires it, the call runs
``RglruScan``, a ``torch.autograd.Function`` whose forward launches K6
and whose backward launches K6's backward, ``rglru_scan_bwd`` (CUDA C++
for ``sm_90a``, ``csrc/rglru_scan_bwd.cu``: the reverse recurrence, a
producer warp filling a ring that a consumer warp walks in batches, bit
for bit the plain ``ref.rglru_scan_bwd``; counted in
``rglru_scan_bwd.launches``); the plain backward takes CPU tensors. So
every family trains on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(a, b, h0):
    ts = (a, b) if h0 is None else (a, b, h0)
    if any(t.device != a.device for t in ts):
        raise ValueError("rglru_scan: all tensors must share a's device")
    if a.dtype not in _CODES or b.dtype != a.dtype:
        raise ValueError(f"rglru_scan: a {a.dtype} / b {b.dtype} must both "
                         f"be float32 or bfloat16")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: bad shapes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if h0 is not None and h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan: h0 {tuple(h0.shape)} is not (B, C) "
                         f"of a {tuple(a.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan: a and b must be contiguous")


def rglru_scan(a, b, h0=None):
    """a, b (B, S, C); h0 (B, C) or None (zeros). Returns h (B, S, C)
    fp32. With grad enabled and an input that requires it, the call goes
    through ``RglruScan``, whose backward is ``rglru_scan_bwd``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        return RglruScan.apply(a, b, h0)
    return _forward(a, b, h0)


def _forward(a, b, h0):
    """The kernel on a CUDA tensor, the plain version on a CPU or meta
    one."""
    if a.device.type in _build.PLAIN_DEVICES:
        return ref.rglru_scan(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    _check_args(a, b, h0)
    if h0 is not None:
        h0 = h0.float().contiguous()
    Bsz, S, C = a.shape
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if h.numel() == 0:
        return h
    fn = _build.load_entry("rglru_scan", "rglru_scan_launch", _ARGTYPES)
    rc = fn(a.data_ptr(), b.data_ptr(),
            h0.data_ptr() if h0 is not None else None, h.data_ptr(), Bsz, S,
            C, _CODES[a.dtype], torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan launch failed: cudaError {rc}")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0


def rglru_scan_bwd(a, h, h0, gh):
    """The gradients (ga, gb, gh0) of ``rglru_scan(a, b, h0)``, whose
    output was ``h`` (B, S, C) fp32, for its gradient ``gh``: ga and gb in
    a's dtype, gh0 fp32 (None where h0 is None). On a CUDA tensor the
    hand-written backward (``csrc/rglru_scan_bwd.cu``), on a CPU or meta tensor
    its plain version, ``ref.rglru_scan_bwd``; the two agree bit for
    bit."""
    if a.device.type in _build.PLAIN_DEVICES:
        return ref.rglru_scan_bwd(a, h, h0, gh)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd: no kernel for device {a.device}")
    _check_args(a, a, h0)
    ts = (h, gh) if h0 is None else (h, gh, h0)
    if any(t.device != a.device or t.dtype != torch.float32 for t in ts) \
            or h.shape != a.shape or gh.shape != a.shape:
        raise ValueError(f"rglru_scan_bwd: h {tuple(h.shape)} and gh "
                         f"{tuple(gh.shape)} must be fp32 of a's shape "
                         f"{tuple(a.shape)} on its device (h0 fp32)")
    h, gh = h.contiguous(), gh.contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    Bsz, S, C = a.shape
    ga, gb = torch.empty_like(a), torch.empty_like(a)
    gh0 = torch.empty_like(h0) if h0 is not None else None
    if Bsz * C == 0:
        return ga, gb, gh0
    fn = _build.load_entry("rglru_scan_bwd", "rglru_scan_bwd_launch",
                           _BWD_ARGTYPES)
    ptr = lambda t: t.data_ptr() if t is not None else None
    rc = fn(*(ptr(t) for t in (a, h, gh, h0, ga, gb, gh0)), Bsz, S, C,
            _CODES[a.dtype], torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan_bwd launch failed: cudaError {rc}")
    rglru_scan_bwd.launches += 1
    return ga, gb, gh0


rglru_scan_bwd.launches = 0


class RglruScan(torch.autograd.Function):
    """K6 under autograd: the forward launches K6 and saves a, h0 and its
    output h; the backward launches ``rglru_scan_bwd`` (the plain
    versions on CPU tensors, so that the CPU tests drive this same
    Function). A bf16 a/b gets bf16 gradients; h0's gradient comes back in
    h0's dtype."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h0f = h0.float().contiguous() if h0 is not None else None
        h = _forward(a, b, h0f)
        ctx.save_for_backward(a, h, h0f)
        ctx.h0_dtype = h0.dtype if h0 is not None else None
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h, h0 = ctx.saved_tensors
        ga, gb, gh0 = rglru_scan_bwd(a, h, h0, gh.float())
        if gh0 is not None:
            gh0 = gh0.to(ctx.h0_dtype)
        return ga, gb, gh0


def bwd_kernel_attrs(a, h, gh):
    """The backward kernel variant a launch on a (B, S, C) and fp32 h, gh
    runs, from the CUDA runtime: as ``kernel_attrs`` (``chunks_16_bytes``:
    its ring is filled in 16-byte chunks, else in 4-byte words), and its
    layout: threads a block (a consumer and a producer warp), ring stages,
    steps a stage and steps a consumer batch."""
    out = (ctypes.c_int * 11)()
    rc = _build.load_entry(
        "rglru_scan_bwd", "rglru_scan_bwd_attrs",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.POINTER(ctypes.c_int)])(
        a.data_ptr(), h.data_ptr(), gh.data_ptr(), a.shape[0], a.shape[2],
        _CODES[a.dtype], out)
    if rc != 0:
        raise RuntimeError(f"rglru_scan_bwd_attrs failed: cudaError {rc}")
    return {"registers": out[0], "smem_bytes": out[1], "local_bytes": out[2],
            "blocks_per_sm": out[3], "grid": [out[4], out[5]],
            "chunks_16_bytes": bool(out[6]), "threads": out[7],
            "consumer_warps": 1, "producer_warps": out[7] // 32 - 1,
            "stages": out[8], "steps_a_stage": out[9],
            "steps_a_batch": out[10]}


def kernel_attrs(a, b):
    """The kernel variant a launch on a, b (B, S, C) runs, from the CUDA
    runtime: its registers, dynamic shared memory, local bytes, resident
    blocks an SM, grid, and whether it copies 16-byte chunks."""
    out = (ctypes.c_int * 7)()
    rc = _build.load_entry(
        "rglru_scan", "rglru_scan_attrs",
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
        + [ctypes.POINTER(ctypes.c_int)])(
        a.data_ptr(), b.data_ptr(), a.shape[0], a.shape[2], _CODES[a.dtype],
        out)
    if rc != 0:
        raise RuntimeError(f"rglru_scan_attrs failed: cudaError {rc}")
    return {"registers": out[0], "smem_bytes": out[1], "local_bytes": out[2],
            "blocks_per_sm": out[3], "grid": [out[4], out[5]],
            "chunks_16_bytes": bool(out[6])}
