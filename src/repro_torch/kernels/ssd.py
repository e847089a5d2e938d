"""Mamba-2 SSD intra-chunk pieces: ``y_intra``, the chunk state,
``exp(total)`` and ``cum`` for every (batch, chunk, head).

Port of ``repro/kernels/ssd.py::ssd_chunk`` with its signature and
layouts: x (B, nc, Q, H, P), dt (B, nc, Q, H) post-softplus, a (H,)
negative, B_/C_ (B, nc, Q, N), all fp32. The kernel is hand-written CUDA
C++ for ``sm_90a`` (``csrc/ssd_chunk.cu``, whose head note says what
bounds it and how the design answers) and runs every chunk length Q from
1 to 1024, in two passes: the head-free scores C.B^T once per chunk into
a scratch the wrapper allocates (``scratch_shape``), then every head's y
and state from them. ``kernels/ref.py`` holds the plain version. A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain
version. ``ssd_chunk.launches`` counts the wrapper's launches (one a
call, both passes).

``error_bound`` gives the tolerance a kernel result is held to against
the plain version on the same inputs (the tests and ``chip_smoke.py``
use it; the serving path does not).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# element sizes the kernel is compiled for (ssm_head_dim and ssm_state of
# mamba2-370m: 64 and 128; of its .reduced() width: 16)
WIDTHS = (16, 32, 64, 128)
QMAX = 1024
# rows of a query or key tile of the kernel's score pass
TILE = 64
# fp32 rounding of the two products and the exp, on both sides: the
# score sums N <= 128 terms and y sums Q <= 256 more, so each side is
# within (N + Q + 4) * 2^-24 < 2.5e-5 of the exact value, relative to the
# sum of the terms' magnitudes; 1e-4 is twice the two sides' gap
REL_TOL = 1e-4


def _check_args(x, dt, a, B_, C_):
    ts = (x, dt, a, B_, C_)
    if any(t.device != x.device for t in ts):
        raise ValueError("ssd_chunk: all tensors must share x's device")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("ssd_chunk: x, dt, a, B and C must be float32")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("ssd_chunk: tensors must be contiguous")
    if x.dim() != 5:
        raise ValueError(f"ssd_chunk: bad shapes x {tuple(x.shape)}")
    Bsz, nc, Q, H, P = x.shape
    N = B_.shape[-1]
    if dt.shape != (Bsz, nc, Q, H) or a.shape != (H,) \
            or B_.shape != (Bsz, nc, Q, N) or C_.shape != B_.shape:
        raise ValueError(f"ssd_chunk: bad shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, B "
                         f"{tuple(B_.shape)}, C {tuple(C_.shape)}")
    if P not in WIDTHS or N not in WIDTHS:
        raise ValueError(f"ssd_chunk: head_dim {P} / state {N} not in "
                         f"{WIDTHS}")
    if Q > QMAX:
        raise ValueError(f"ssd_chunk: chunk of {Q} rows > {QMAX}")
    if any(t.data_ptr() % 16 for t in (x, B_, C_)):
        raise ValueError("ssd_chunk: x, B and C must be 16-byte aligned")


def scratch_shape(BC, Q):
    """The score pass's fp32 scratch for BC = batch * chunks chunks of Q
    rows: the lower-triangle pairs of 64-row query and key tiles, diagonal
    included, each a packed (64, 64) tile of C.B^T."""
    T = -(-Q // TILE)
    return (BC, T * (T + 1) // 2, TILE, TILE)


def _scratch(shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def ssd_chunk(x, dt, a, B_, C_):
    """x (B, nc, Q, H, P); dt (B, nc, Q, H); a (H,); B_/C_ (B, nc, Q, N).
    Returns (y_intra (B, nc, Q, H, P), state (B, nc, H, P, N), decay
    (B, nc, H), cum (B, nc, Q, H)), all fp32."""
    if x.device.type == "cpu":
        return ref.ssd_chunk(x, dt, a, B_, C_)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: no kernel for device {x.device}")
    _build.refuse_grad("ssd_chunk", (x, dt, a, B_, C_),
                       "its backward waits for ROADMAP P14b")
    _check_args(x, dt, a, B_, C_)
    Bsz, nc, Q, H, P = x.shape
    N = B_.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty(Bsz, nc, H, P, N, dtype=x.dtype, device=x.device)
    decay = torch.empty(Bsz, nc, H, dtype=x.dtype, device=x.device)
    cum = torch.empty_like(dt)
    if Bsz * nc * Q * H == 0:
        return y, state, decay, cum
    scratch = _scratch(scratch_shape(Bsz * nc, Q), x.device)
    fn = _build.load_entry("ssd_chunk", "ssd_chunk_launch", _ARGTYPES)
    rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), B_.data_ptr(),
            C_.data_ptr(), y.data_ptr(), state.data_ptr(), decay.data_ptr(),
            cum.data_ptr(), scratch.data_ptr(), Bsz * nc, Q, H, P, N,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk launch failed: cudaError {rc}")
    ssd_chunk.launches += 1
    return y, state, decay, cum


ssd_chunk.launches = 0


def kernel_attrs(x, B_):
    """The two passes the kernel launches for x (B, nc, Q, H, P) and B_
    (B, nc, Q, N), from the CUDA runtime: {"score": ..., "head": ...},
    each its registers, dynamic shared memory, local bytes, resident
    blocks an SM and grid."""
    Bsz, nc, Q, H, P = x.shape
    out = (ctypes.c_int * 14)()
    rc = _build.load_entry(
        "ssd_chunk", "ssd_chunk_attrs",
        [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)])(
        Bsz * nc, Q, H, P, B_.shape[-1], out)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_attrs failed: cudaError {rc}")
    keys = ("registers", "smem_bytes", "local_bytes", "blocks_per_sm")
    return {name: {**dict(zip(keys, out[7 * i:7 * i + 4])),
                   "grid": list(out[7 * i + 4:7 * i + 7])}
            for i, name in enumerate(("score", "head"))}


def error_bound(x, dt, a, B_, C_, cum_got, cum_want):
    """Per-element tolerances of (y_intra, state, decay, cum) computed one
    way against another on the same inputs (dt >= 0, as after softplus).

    ``cum`` is a prefix sum of Q terms of one sign: any summation order is
    within (Q - 1) * 2^-24 * |cum| of the exact value, so two orders differ
    by at most twice that; at a = -32 and dt ~ 1, |cum| reaches ~8,000 by
    row 256, an absolute ~0.06 in the worst case. Every decay factor is an
    exp of a difference of two cum values (or of ``total``), so where the
    two sides' cum differ by ``dc`` (per batch, chunk and head) a factor
    differs by a relative e^(2 dc) - 1. The bound of each output is
    therefore (REL_TOL + e^(2 dc) - 1) times the sum of its terms'
    magnitudes, which is the plain version run on |x|, |B| and |C|, plus
    1e-6. Returns (bounds of the four outputs, dc)."""
    Q = x.shape[2]
    dc = (cum_got - cum_want).abs().amax(dim=2)            # (B, nc, H)
    worst = 2 * (Q - 1) * 2.0 ** -24 * cum_want.abs().amax(dim=2)
    y_mag, st_mag, dec_mag, _ = ref.ssd_chunk(x.abs(), dt, a, B_.abs(),
                                              C_.abs())
    rel = REL_TOL + torch.expm1(2 * dc)
    return ((rel[:, :, None, :, None] * y_mag + 1e-6,
             rel[:, :, :, None, None] * st_mag + 1e-6,
             rel * dec_mag + 1e-6,
             (worst + 1e-6)[:, :, None, :].expand_as(cum_want)), dc)
