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
tensor launches the kernel or raises; a CPU or meta tensor takes the plain
version. ``ssd_chunk.launches`` counts the wrapper's launches (one a
call, both passes).

Training: with grad enabled and an input that requires it, the call runs
``SsdChunk``, a ``torch.autograd.Function`` whose forward launches K5 and
whose backward launches K5's backward, ``ssd_chunk_bwd`` (CUDA C++ for
``sm_90a``, ``csrc/ssd_chunk_bwd.cu``: five launches counted as one in
``ssd_chunk_bwd.launches``, the products of three of them on tensor cores
in 3xTF32); the plain backward (``ref.ssd_chunk_bwd``)
takes CPU tensors. So every family trains on the card.

``error_bound`` and ``bwd_error_bound`` give the tolerances a kernel
result is held to against the plain version on the same inputs (the
tests and ``chip_smoke.py`` use them; the serving and train paths do
not).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]
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
    (B, nc, H), cum (B, nc, Q, H)), all fp32. With grad enabled and an
    input that requires it, the call goes through ``SsdChunk``, whose
    backward is ``ssd_chunk_bwd``."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, a, B_, C_)):
        return SsdChunk.apply(x, dt, a, B_, C_)
    return _forward(x, dt, a, B_, C_)


def _forward(x, dt, a, B_, C_):
    """The kernel on a CUDA tensor, the plain version on a CPU or meta
    one."""
    if x.device.type in _build.PLAIN_DEVICES:
        return ref.ssd_chunk(x, dt, a, B_, C_)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: no kernel for device {x.device}")
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


def _grad_arg(name, g, shape, like):
    """An upstream gradient as the backward kernel reads it: fp32,
    contiguous, 16-byte aligned, of ``shape`` (zeros for None)."""
    if g is None:
        return torch.zeros(shape, dtype=torch.float32, device=like.device)
    if tuple(g.shape) != tuple(shape) or g.device != like.device:
        raise ValueError(f"ssd_chunk_bwd: {name} {tuple(g.shape)} on "
                         f"{g.device} is not {tuple(shape)} on "
                         f"{like.device}")
    g = g.float().contiguous()
    return g.clone() if g.data_ptr() % 16 else g


def ssd_chunk_bwd(x, dt, a, B_, C_, cum, gy, gstate, gdecay=None,
                  gcum=None):
    """The gradients (gx, gdt, ga, gB, gC) of ``ssd_chunk(x, dt, a, B_,
    C_)``, whose ``cum`` output was ``cum``, for the gradients of its four
    outputs (any of them None for zeros). On a CUDA tensor the
    hand-written backward (``csrc/ssd_chunk_bwd.cu``: five launches,
    counted as one in ``ssd_chunk_bwd.launches``; the pair, head and chunk
    passes take their products on tensor cores in 3xTF32, each sum in a
    fixed order, no atomics), on a CPU or meta tensor its plain version,
    ``ref.ssd_chunk_bwd``."""
    if x.device.type in _build.PLAIN_DEVICES:
        return ref.ssd_chunk_bwd(x, dt, a, B_, C_, cum, gy, gstate, gdecay,
                                 gcum)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bwd: no kernel for device {x.device}")
    _check_args(x, dt, a, B_, C_)
    Bsz, nc, Q, H, P = x.shape
    N = B_.shape[-1]
    if cum.shape != dt.shape or cum.dtype != torch.float32 \
            or not cum.is_contiguous() or cum.device != x.device:
        raise ValueError(f"ssd_chunk_bwd: cum {tuple(cum.shape)} must be a "
                         f"contiguous fp32 {tuple(dt.shape)}")
    gy = _grad_arg("gy", gy, x.shape, x)
    gstate = _grad_arg("gstate", gstate, (Bsz, nc, H, P, N), x)
    gdecay = (_grad_arg("gdecay", gdecay, (Bsz, nc, H), x)
              if gdecay is not None else None)
    gcum = _grad_arg("gcum", gcum, dt.shape, x) if gcum is not None else None
    gx, gdt = torch.empty_like(x), torch.empty_like(dt)
    gB, gC = torch.empty_like(B_), torch.empty_like(C_)
    ga = torch.empty(H, dtype=torch.float32, device=x.device)
    BC = Bsz * nc
    if BC * Q * H == 0:
        return gx.zero_(), gdt.zero_(), ga.zero_(), gB.zero_(), gC.zero_()
    tiles = scratch_shape(BC, Q)
    scores, sbar = _scratch(tiles, x.device), _scratch(tiles, x.device)
    part = _scratch((BC, tiles[1], 3, H, TILE), x.device)
    wbar = _scratch((BC, Q, H), x.device)
    ga_part = _scratch((BC, H), x.device)
    fn = _build.load_entry("ssd_chunk_bwd", "ssd_chunk_bwd_launch",
                           _BWD_ARGTYPES)
    ptr = lambda t: t.data_ptr() if t is not None else None
    rc = fn(*(ptr(t) for t in (x, dt, a, B_, C_, cum, gy, gstate, gdecay,
                               gcum, gx, gdt, ga, gB, gC, scores, sbar, part,
                               wbar, ga_part)),
            BC, Q, H, P, N, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_bwd launch failed: cudaError {rc}")
    ssd_chunk_bwd.launches += 1
    return gx, gdt, ga, gB, gC


ssd_chunk_bwd.launches = 0


class SsdChunk(torch.autograd.Function):
    """K5 under autograd: the forward launches K5 and saves its inputs and
    ``cum``; the backward launches ``ssd_chunk_bwd`` (the plain versions on
    CPU tensors, so that the CPU tests drive this same Function). An
    output the loss does not reach passes no gradient (None, zeros)."""

    @staticmethod
    def forward(ctx, x, dt, a, B_, C_):
        out = _forward(x, dt, a, B_, C_)
        ctx.save_for_backward(x, dt, a, B_, C_, out[3])
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, gy, gstate, gdecay, gcum):
        return ssd_chunk_bwd(*ctx.saved_tensors, gy, gstate, gdecay, gcum)


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


def bwd_kernel_attrs(x, B_):
    """The five passes K5's backward launches for x (B, nc, Q, H, P) and
    B_ (B, nc, Q, N), from the CUDA runtime: {"pair", "head", "bc", "vec",
    "ga"}, each its registers, dynamic shared memory, local bytes,
    resident blocks an SM and grid."""
    Bsz, nc, Q, H, P = x.shape
    out = (ctypes.c_int * 35)()
    rc = _build.load_entry(
        "ssd_chunk_bwd", "ssd_chunk_bwd_attrs",
        [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)])(
        Bsz * nc, Q, H, P, B_.shape[-1], out)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_bwd_attrs failed: cudaError {rc}")
    keys = ("registers", "smem_bytes", "local_bytes", "blocks_per_sm")
    return {name: {**dict(zip(keys, out[7 * i:7 * i + 4])),
                   "grid": list(out[7 * i + 4:7 * i + 7])}
            for i, name in enumerate(("pair", "head", "bc", "vec", "ga"))}


def bwd_error_bound(x, dt, a, B_, C_, cum, gy, gstate, gdecay=None,
                    gcum=None):
    """Per-element tolerances of (gx, gdt, ga, gB, gC) computed one way
    against another on the same inputs, ``cum`` included (dt >= 0).

    Both sides round every product and sum in fp32, in other orders: a
    sum of n terms is within (n - 1) 2^-24 of the sum of its terms'
    magnitudes, and a chain of sums within the sum of their counts. The
    longest chain of each output, from the formulas
    (``ref.ssd_chunk_bwd``): gx sums Q rows of M (scores of N terms) and
    N state terms; gC sums Q rows of S_bar (H heads of G, P terms each);
    gB that, or H x P state terms; gdt sums Q rows of G S L (P + N), then
    the Q-row reverse cumsum; ga sums gdA over every batch, chunk and row
    on top of that. 8 more cover the products and exp's last bits. Each
    bound is twice that count times 2^-24 (two sides) times the sum of
    its terms' magnitudes (``_bwd_magnitudes``), plus 1e-6."""
    Bsz, nc, Q, H, P = x.shape
    N = B_.shape[-1]
    mags = _bwd_magnitudes(x, dt, a, B_, C_, cum, gy, gstate, gdecay, gcum)
    gdt_n = 2 * Q + P + N
    terms = (Q + N, gdt_n, Bsz * nc * Q + gdt_n,
             max(Q + H + P, H * P), Q + H + P)
    return tuple(2 * (n + 8) * 2.0 ** -24 * m + 1e-6
                 for n, m in zip(terms, mags))


def _bwd_magnitudes(x, dt, a, B_, C_, cum, gy, gstate, gdecay, gcum):
    """The sum of the terms' magnitudes of each of (gx, gdt, ga, gB, gC):
    ``ref.ssd_chunk_bwd``'s formulas with every input taken by its
    absolute value and every difference made a sum (dt, L and the decay
    factors are non-negative already)."""
    Q = x.shape[2]
    x, a, B_, C_ = x.abs(), a.abs(), B_.abs(), C_.abs()
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = torch.exp(torch.where(tri[None, None, :, :, None], dec,
                              torch.full_like(dec, float("-inf"))))
    total = cum[:, :, -1, :]
    e = torch.exp(total[:, :, None, :] - cum)
    w = e * dt
    gx, gdt = torch.zeros_like(x), torch.zeros_like(dt)
    gB, gC = torch.zeros_like(B_), torch.zeros_like(C_)
    gc = gcum.abs() if gcum is not None else torch.zeros_like(cum)
    if gy is not None:
        gy = gy.abs()
        S = torch.einsum("bcqn,bckn->bcqk", C_, B_)
        LD = L * dt[:, :, None, :, :]
        gx = torch.einsum("bcts,bctsh,bcthp->bcshp", S, LD, gy)
        G = torch.einsum("bcthp,bcshp->bctsh", gy, x)
        S_bar = (G * LD).sum(-1)
        gC = torch.einsum("bcts,bcsn->bctn", S_bar, B_)
        gB = torch.einsum("bcts,bctn->bcsn", S_bar, C_)
        GSL = G * S[..., None] * L
        gdt = GSL.sum(2)
        R = GSL * dt[:, :, None, :, :]
        gc = gc + R.sum(3) + R.sum(2)
    if gstate is not None:
        gstate = gstate.abs()
        V = torch.einsum("bchpn,bcsn->bcshp", gstate, B_)
        gx = gx + w[..., None] * V
        wbar = (x * V).sum(-1)
        gB = gB + torch.einsum("bcsh,bchpn,bcshp->bcsn", w, gstate, x)
        gdt = gdt + wbar * e
        gc = gc + wbar * w
        gc[:, :, -1] += (wbar * w).sum(2)
    if gdecay is not None:
        gc[:, :, -1] += gdecay.abs() * torch.exp(total)
    gdA = torch.flip(torch.cumsum(torch.flip(gc, (2,)), 2), (2,))
    return gx, gdt + gdA * a, (gdA * dt).sum((0, 1, 2)), gB, gC


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
