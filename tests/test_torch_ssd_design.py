"""The numeric design of K5 ``ssd_chunk`` on Hopper
(``src/repro_torch/csrc/ssd_chunk.cu``), modelled in numpy so that the
CPU checks its arithmetic:

(a) Two passes. The score pass computes C.B^T once per (batch, chunk),
    over the lower-triangle pairs of 64-row query and key tiles (diagonal
    included), into a scratch of packed (64, 64) tiles; it also takes
    ``cum``, the inclusive prefix sum of the rounded products dt * a,
    serially in row order in fp32. The head pass then, per head, masks
    s <= t before the exp (a masked pair is exp(-inf) = 0), scales each
    score by exp(cum[t] - cum[s]) dt[s] and multiplies into x, tile by
    tile; and takes the state as (x w)^T.B with w = exp(cum[Q-1] - cum[s])
    dt[s]. Every product goes through ``split_product`` of
    tests/test_torch_prefill_split.py at 3 passes (hi.hi' + hi.lo' +
    lo.hi', as ``common.cuh`` splits fp32 operands for the tensor cores).
    The result must hold to ``kernels.ssd.error_bound`` against the port's
    plain version and against the JAX reference (``repro.kernels.ssd``,
    the Pallas kernel in interpret mode) at chunk lengths 37, 64, 100 and
    256, with a strongly decaying head (a = -32, dt ~ 1: |cum| reaches
    ~8,000 by row 256).

(b) One TF32 pass (operands rounded to 10 mantissa bits) misses that
    bound: a row's first terms carry ~2^-11 of relative error each, ten
    times the bound's 1e-4. That is why the kernel takes three.

(c) The serial ``cum``. On the card ``torch.cumsum`` along a
    non-innermost dimension is a serial fp32 loop, so the kernel's cum is
    bit-equal to the plain version's there (tests/test_torch_kernels_cuda.py
    and ``chip_smoke.py`` check it). The plain version sums in that order
    on every device (``ref.prefix_sum``; on the CPU ``torch.cumsum`` would
    accumulate in fp64), so here the serial sum is checked bit for bit
    against numpy's fp32 accumulation and against the plain version.

(d) The scratch the wrapper allocates, from the shapes alone.

(e) The backward (``src/repro_torch/csrc/ssd_chunk_bwd.cu``): its pair,
    head and chunk passes take every product (S = C.B^T, G = gy.x^T, V =
    B.gstate^T, M^T.gy, S_bar.B, S_bar^T.C and the heads' (w x).gstate) in
    3xTF32, the rest in fp32. Modelled here with ``split_product``, the
    gradients hold to ``kernels.ssd.bwd_error_bound`` against the port's
    plain backward at ragged and whole chunks with a strongly decaying
    head; one TF32 pass misses it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd as jssd
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as tssd
from test_torch_prefill_split import split_product, tf32_rn

TILE = 64


def _draw(seed, Bsz, nc, Q, H, P, N, strong=False):
    """Mamba-2's post-conv chunk inputs at its init (tests/test_torch_ssd.py):
    x, B and C silu of unit normals, dt = softplus(N(0,1) + dt_bias), a =
    -(1..H); ``strong``: the last head decays at a = -32, dt ~ U[0.9, 1.1]."""
    rng = np.random.default_rng(seed)

    def silu(v):
        return v / (1.0 + np.exp(-v))

    x = silu(rng.standard_normal((Bsz, nc, Q, H, P)))
    B_ = silu(rng.standard_normal((Bsz, nc, Q, N)))
    C_ = silu(rng.standard_normal((Bsz, nc, Q, N)))
    u = rng.uniform(1e-3, 1e-1, H)
    dt = np.logaddexp(rng.standard_normal((Bsz, nc, Q, H))
                      + np.log(np.expm1(u)), 0.0)
    a = -np.arange(1, H + 1, dtype=np.float64)
    if strong:
        a[-1] = -32.0
        dt[..., -1] = rng.uniform(0.9, 1.1, (Bsz, nc, Q))
    return tuple(np.asarray(t, np.float32) for t in (x, dt, a, B_, C_))


def serial_cum(dt, a):
    """dt (Q, H), a (H,): the rounded products dt * a summed in row order
    in fp32, each prefix rounded, as a lane of the score pass sums them."""
    dA = (dt * a).astype(np.float32)
    out = np.empty_like(dA)
    acc = np.zeros(dA.shape[1], np.float32)
    for s in range(dA.shape[0]):
        acc = (acc + dA[s]).astype(np.float32)
        out[s] = acc
    return out


def score_tiles(Bc, Cc, passes):
    """The score pass for one chunk, B/C (Q, N): the packed lower-triangle
    tiles (T(T+1)/2, 64, 64), rows and keys past Q zero."""
    Q, N = Bc.shape
    T = -(-Q // TILE)
    pad = ((0, T * TILE - Q), (0, 0))
    Bp, Cp = np.pad(Bc, pad), np.pad(Cc, pad)
    tiles = []
    for qi in range(T):
        for kj in range(qi + 1):
            tiles.append(split_product(Cp[qi * TILE:(qi + 1) * TILE],
                                       Bp[kj * TILE:(kj + 1) * TILE].T,
                                       False, False, passes))
    return np.stack(tiles).astype(np.float32)


def model_ssd_chunk(x, dt, a, B_, C_, passes=3):
    """Both passes of the kernel, in numpy: returns (y_intra, state, decay,
    cum) in the layouts of ``ref.ssd_chunk`` and the score tiles."""
    Bsz, nc, Q, H, P = x.shape
    T = -(-Q // TILE)
    y = np.zeros_like(x)
    state = np.zeros((Bsz, nc, H, P, B_.shape[-1]), np.float32)
    decay = np.zeros((Bsz, nc, H), np.float32)
    cum = np.zeros_like(dt)
    all_tiles = []
    for b in range(Bsz):
        for c in range(nc):
            tiles = score_tiles(B_[b, c], C_[b, c], passes)
            all_tiles.append(tiles)
            cs = serial_cum(dt[b, c], a)
            cum[b, c] = cs
            decay[b, c] = np.exp(cs[-1])
            cp = np.pad(cs, ((0, T * TILE - Q), (0, 0)))
            dp = np.pad(dt[b, c], ((0, T * TILE - Q), (0, 0)))
            xp = np.pad(x[b, c], ((0, T * TILE - Q), (0, 0), (0, 0)))
            for h in range(H):
                for qi in range(T):
                    t = qi * TILE + np.arange(TILE)
                    acc = np.zeros((TILE, P), np.float32)
                    for kj in range(qi + 1):
                        s = kj * TILE + np.arange(TILE)
                        live = (s[None, :] <= t[:, None]) & (t[:, None] < Q)
                        dec = np.where(live, cp[t, h][:, None]
                                       - cp[s, h][None, :], -np.inf)
                        sc = tiles[qi * (qi + 1) // 2 + kj]
                        att = np.where(live, sc * np.exp(dec.astype(
                            np.float32)) * dp[s, h][None, :], 0.0)
                        acc = (acc + split_product(
                            att.astype(np.float32), xp[s, h], False, False,
                            passes)).astype(np.float32)
                    tn = min(TILE, Q - qi * TILE)
                    y[b, c, qi * TILE:qi * TILE + tn, h] = acc[:tn]
                w = (np.exp(cs[-1, h] - cs[:, h]) * dt[b, c, :, h]).astype(
                    np.float32)
                xw = (x[b, c, :, h] * w[:, None]).astype(np.float32)
                state[b, c, h] = split_product(xw.T, B_[b, c], False, False,
                                               passes).astype(np.float32)
    return (y, state, decay, cum), all_tiles


def _bound_excess(got, want, inputs):
    """Largest gap over bound, per output, of ``got`` against ``want``."""
    got = [torch.from_numpy(np.array(g)) for g in got]
    want = [torch.from_numpy(np.array(w)) for w in want]
    bounds, _ = tssd.error_bound(*inputs, got[3], want[3])
    return [float(((g - w).abs() - bd).max())
            for g, w, bd in zip(got, want, bounds)]


CASES = [
    (1, 1, 37, 2, 16, 32, False),       # one ragged tile
    (1, 2, 64, 3, 16, 16, True),        # one whole tile, strong decay
    (2, 1, 100, 2, 16, 32, False),      # two tiles, the second ragged
    (1, 1, 256, 2, 16, 32, True),       # mamba2's chunk, |cum| ~ 8e3
]


@pytest.mark.parametrize("Bsz,nc,Q,H,P,N,strong", CASES)
def test_two_pass_design_holds_to_the_bound(Bsz, nc, Q, H, P, N, strong):
    arrs = _draw(Q + H, Bsz, nc, Q, H, P, N, strong)
    inputs = tuple(torch.from_numpy(v.copy()) for v in arrs)
    got, _ = model_ssd_chunk(*arrs)
    plain = [v.numpy() for v in tref.ssd_chunk(*inputs)]
    assert all(e <= 0 for e in _bound_excess(got, plain, inputs))
    jax_out = [np.asarray(v) for v in
               jssd.ssd_chunk(*map(jnp.asarray, arrs), interpret=True)]
    assert all(e <= 0 for e in _bound_excess(got, jax_out, inputs))


def test_one_tf32_pass_misses_the_bound():
    arrs = _draw(7, 1, 1, 64, 2, 16, 32)
    inputs = tuple(torch.from_numpy(v.copy()) for v in arrs)
    plain = [v.numpy() for v in tref.ssd_chunk(*inputs)]
    three, _ = model_ssd_chunk(*arrs, passes=3)
    one, _ = model_ssd_chunk(*arrs, passes=1)
    assert all(e <= 0 for e in _bound_excess(three, plain, inputs))
    y_excess, state_excess = _bound_excess(one, plain, inputs)[:2]
    assert y_excess > 0 and state_excess > 0


def test_tf32_operands_lose_the_low_bits():
    """A TF32 operand keeps 10 mantissa bits: rounding moves a value by up
    to 2^-11 of itself, the error one pass carries into every product."""
    v = np.float32(1.0 + 2.0 ** -12 + 2.0 ** -20)
    assert tf32_rn(np.array([v]))[0] != v
    assert abs(tf32_rn(np.array([v]))[0] - v) <= 2.0 ** -11 * v


@pytest.mark.parametrize("Q,strong", [(37, False), (256, True), (1024, True)])
def test_serial_cum_is_fp32_in_row_order(Q, strong):
    _, dt, a, _, _ = _draw(Q, 1, 1, Q, 3, 16, 16, strong)
    cs = serial_cum(dt[0, 0], a)
    # numpy accumulates fp32 in order: the card's torch.cumsum order
    want = np.cumsum((dt[0, 0] * a).astype(np.float32), axis=0,
                     dtype=np.float32)
    assert np.array_equal(cs, want)
    # the plain version sums in the same order on the CPU too
    plain = tref.ssd_chunk(*(torch.from_numpy(v.copy()) for v in
                             _draw(Q, 1, 1, Q, 3, 16, 16, strong)))[3]
    assert np.array_equal(plain[0, 0].numpy(), cs)


@pytest.mark.parametrize("BC,Q,want", [
    (1, 1, (1, 1, 64, 64)),
    (1, 37, (1, 1, 64, 64)),
    (2, 64, (2, 1, 64, 64)),
    (1, 65, (1, 3, 64, 64)),
    (6, 256, (6, 10, 64, 64)),          # a ~1,500-token mamba2 note
    (1, 1024, (1, 136, 64, 64)),
])
def test_scratch_is_the_packed_lower_triangle(BC, Q, want):
    assert tssd.scratch_shape(BC, Q) == want
    T = -(-Q // TILE)
    assert want[1] == sum(qi + 1 for qi in range(T))


def test_scratch_holds_every_tile_the_model_reads():
    arrs = _draw(3, 2, 1, 100, 2, 16, 16)
    _, tiles = model_ssd_chunk(*arrs)
    shape = tssd.scratch_shape(2, 100)
    assert len(tiles) == shape[0]
    assert all(t.shape == shape[1:] for t in tiles)
    # the 1,500-token note's scratch stays under 1 MB (L2 holds 50 MB)
    assert 4 * np.prod(tssd.scratch_shape(6, 256)) == 983040


# ------------------------------------------------ (e) the backward's products

def model_ssd_chunk_bwd(x, dt, a, B_, C_, cum, gy, gstate, gdecay, gcum,
                        passes=3):
    """K5's backward in numpy, ``ref.ssd_chunk_bwd``'s formulas with every
    product of the kernel's pair, head and chunk passes through
    ``split_product`` at ``passes`` TF32 passes, and the elementwise terms,
    the sums over the heads and the reverse cumsum in fp32. Returns (gx,
    gdt, ga, gB, gC)."""
    Bsz, nc, Q, H, P = x.shape
    f32 = np.float32
    tri = np.tril(np.ones((Q, Q), bool))
    gx, gdt = np.zeros_like(x), np.zeros_like(dt)
    gB, gC = np.zeros_like(B_), np.zeros_like(C_)
    ga = np.zeros(H, f32)

    def mm(u, v):
        return split_product(u.astype(f32), v.astype(f32), False, False,
                             passes).astype(f32)

    for b in range(Bsz):
        for c in range(nc):
            Bc, Cc, cs = B_[b, c], C_[b, c], cum[b, c]
            S = mm(Cc, Bc.T)
            S_bar = np.zeros((Q, Q), f32)
            for h in range(H):
                xh, gyh, d = x[b, c, :, h], gy[b, c, :, h], dt[b, c, :, h]
                dec = np.where(tri, cs[:, h, None] - cs[None, :, h], -np.inf)
                L = np.exp(dec.astype(f32))
                LD = (L * d[None, :]).astype(f32)
                G = mm(gyh, xh.T)
                e = np.exp(cs[-1, h] - cs[:, h]).astype(f32)
                w = (e * d).astype(f32)
                V = mm(Bc, gstate[b, c, h].T)
                gx[b, c, :, h] = mm((S * LD).T, gyh) + w[:, None] * V
                wbar = (xh * V).sum(-1, dtype=f32)
                S_bar += G * LD
                GSL = (G * S * L).astype(f32)
                R = (GSL * d[None, :]).astype(f32)
                g = gcum[b, c, :, h] + R.sum(1) - R.sum(0) - wbar * w
                g[-1] += (wbar * w).sum() + gdecay[b, c, h] * np.exp(
                    cs[-1, h])
                gdA = np.cumsum(g[::-1].astype(f32), dtype=f32)[::-1]
                gdt[b, c, :, h] = GSL.sum(0) + wbar * e + gdA * a[h]
                ga[h] += (gdA * d).sum(dtype=f32)
                gB[b, c] += mm(w[:, None] * xh, gstate[b, c, h])
            gC[b, c] = mm(S_bar, Bc)
            gB[b, c] += mm(S_bar.T, Cc)
    return gx, gdt, ga, gB, gC


@pytest.mark.parametrize("Bsz,nc,Q,H,P,N,strong", [
    (1, 1, 37, 2, 16, 32, False),      # one ragged tile
    (1, 2, 64, 3, 16, 16, True),       # a whole tile, a = -32
    (1, 1, 100, 2, 32, 32, True),      # two tiles, the second ragged
])
def test_split_backward_holds_the_backward_bound(Bsz, nc, Q, H, P, N,
                                                 strong):
    arrs = _draw(Q + H + 5, Bsz, nc, Q, H, P, N, strong)
    inputs = [torch.from_numpy(v.copy()) for v in arrs]
    cum = tref.ssd_chunk(*inputs)[3]
    rng = np.random.default_rng(Q)
    grads = [rng.standard_normal(sh).astype(np.float32) for sh in (
        (Bsz, nc, Q, H, P), (Bsz, nc, H, P, arrs[3].shape[-1]),
        (Bsz, nc, H), (Bsz, nc, Q, H))]
    args = (*inputs, cum, *map(torch.from_numpy, grads))
    want = tref.ssd_chunk_bwd(*args)
    bounds = tssd.bwd_error_bound(*args)

    def excess(passes):
        got = model_ssd_chunk_bwd(*arrs, cum.numpy(), *grads, passes=passes)
        return [float((np.abs(g - w.numpy()) - bd.numpy()).max())
                for g, w, bd in zip(got, want, bounds)]

    assert all(e <= 0 for e in excess(3)), excess(3)
    # one pass: each product's terms carry ~2^-11 of themselves, far past
    # the bound's (n + 8) 2^-23 of the terms' magnitudes, in gx, gB and gC
    one = excess(1)
    assert one[0] > 0 and one[3] > 0 and one[4] > 0, one
