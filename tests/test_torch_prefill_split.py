"""The two numeric ideas of the prefill walk on tensor cores (K2
``chunked_prefill_attention``, K4 ``flash_attention``,
``src/repro_torch/csrc/prefill_walk.cuh``), modelled in plain PyTorch and
numpy so that the CPU checks the design's arithmetic:

(a) The split key walk. Each q tile's keys are cut into contiguous ranges
    of whole 64-key tiles; each range gives its unnormalised (m, l, acc)
    under the kernels' rules (masked logits at the finite ``NEG_INF``, a
    masked key's p set to 0 outright), and the ranges merge in a fixed
    order: m = max m_i, l = sum l_i e^(m_i - m), o = sum acc_i e^(m_i - m)
    / max(l, 1e-30). The merged output must match the port's plain
    versions and the JAX reference (``repro.kernels.ref``, and the Pallas
    kernel in interpret mode for one case) within 1e-5: both sides compute
    in fp32 and differ only in summation order and exp's last bits. A
    range with no key its rows may attend must contribute exactly zero.

(b) The 3xTF32 split. ``cvt.rna.tf32.f32`` (round to nearest, ties away,
    to 10 mantissa bits) is emulated with integer bit operations, as the
    kernel computes it, and so is the kernel's lo = x - hi with its 13 low
    bits cleared. A
    product of TF32 values is exact in fp32, so the tensor core's error is
    the rounding of its operands: one pass of TF32 puts the attention
    output off by more than the kernels' ``KERNEL_TOL`` of 1e-4 at
    smollm-135m's (D 64) and recurrentgemma-9b's (D 256) heads, while
    hi.hi' + hi.lo' + lo.hi' (two passes where one side is bf16, which is
    exact in TF32) stays within a tenth of it. The emulation sums in fp64:
    the accumulator's own fp32 rounding is the plain version's too.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.chunked_prefill import \
    chunked_prefill_attention as pallas_chunked
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref

NEG_INF = tref.NEG_INF
KT = 64                 # keys a tile of the walk (64 at D <= 128 in bf16)
KERNEL_TOL = 1e-4       # chip_smoke.py: a kernel against its plain version
SPLIT_TOL = 1e-5        # fp32 on both sides, another summation order


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ------------------------------------------------------ (a) the split walk

def range_partial(q, k, v, qpos, kbeg, kend, scale, window=None):
    """One range [kbeg, kend) of keys for query rows q (R, D) at positions
    qpos (R,) over k/v (K, D): the unnormalised (m, l, acc), a masked
    key's p 0 outright (so a range a row may not attend leaves (NEG_INF,
    0, 0)), as the kernel keeps them."""
    R, D = q.shape
    if kend <= kbeg:
        return (torch.full((R,), NEG_INF), torch.zeros(R),
                torch.zeros(R, D))
    s = (q @ k[kbeg:kend].T) * scale
    kpos = torch.arange(kbeg, kend)
    ok = kpos[None, :] <= qpos[:, None]
    if window:
        ok &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.max(dim=-1).values
    p = torch.where(ok, torch.exp(s - m[:, None]), torch.zeros_like(s))
    return m, p.sum(-1), p @ v[kbeg:kend]


def merge(parts):
    """The ranges' (m, l, acc) combined in their order."""
    m = parts[0][0]
    for mi, _, _ in parts[1:]:
        m = torch.maximum(m, mi)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for mi, li, ai in parts:
        w = torch.exp(mi - m)
        l = l + li * w
        acc = acc + ai * w[:, None]
    return acc / torch.clamp(l, min=1e-30)[:, None]


def split_attention(q, k, v, qpos, bounds, scale, window=None):
    """q (T, H, D) at positions qpos (T,) over k/v (K, Hkv, D), each query
    head against its kv head, keys cut at ``bounds``; returns the merged
    output and every range's partials."""
    T, H, D = q.shape
    G = H // k.shape[1]
    out = torch.empty(T, H, D)
    parts_all = []
    for hq in range(H):
        parts = [range_partial(q[:, hq], k[:, hq // G], v[:, hq // G], qpos,
                               lo, hi, scale, window)
                 for lo, hi in zip(bounds[:-1], bounds[1:])]
        out[:, hq] = merge(parts)
        parts_all.append(parts)
    return out, parts_all


@pytest.mark.parametrize("S,H,Hkv,D,window,bounds", [
    (200, 9, 3, 64, None, (0, 64, 64, 128, 200)),        # an empty range
    (256, 4, 1, 32, None, (0, 192, 256)),
    (300, 16, 1, 64, 40, (0, 64, 128, 192, 256, 300)),   # ranges below windows
    (150, 6, 3, 64, None, (0, 150)),                      # one range
])
def test_split_merge_matches_flash_references(S, H, Hkv, D, window, bounds):
    q, k, v = _draw(S + H, (1, S, H, D), (1, S, Hkv, D), (1, S, Hkv, D))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    scale = D ** -0.5
    got, parts = split_attention(tq[0], tk[0], tv[0], torch.arange(S),
                                 bounds, scale, window)
    want = tref.flash_attention(tq, tk, tv, scale, True, window)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=SPLIT_TOL)
    if window is None:
        # the JAX reference's (B*H, S, D) layout
        jq = jnp.asarray(q.transpose(0, 2, 1, 3).reshape(H, S, D))
        jk, jv = (jnp.asarray(a.transpose(0, 2, 1, 3).reshape(Hkv, S, D))
                  for a in (k, v))
        jo = np.asarray(jref.flash_attention(jq, jk, jv, scale, True))
        np.testing.assert_allclose(got.numpy(), jo.reshape(H, S, D)
                                   .transpose(1, 0, 2), rtol=0,
                                   atol=SPLIT_TOL)
    # a range past a row's horizon, or wholly below its window, is empty
    # for that row: it adds exactly nothing
    for hparts in parts:
        for (lo, hi), (m, l, acc) in zip(zip(bounds[:-1], bounds[1:]),
                                         hparts):
            qpos = torch.arange(S)
            dead = (qpos < lo) | (hi <= lo)
            if window:
                dead |= qpos - window >= hi - 1
            assert torch.all(m[dead] == NEG_INF)
            assert torch.all(l[dead] == 0) and torch.all(acc[dead] == 0)
    if len(bounds) > 2 and bounds[1] == bounds[2]:
        # dropping the empty range changes no bit
        kept = bounds[:2] + bounds[3:]
        again, _ = split_attention(tq[0], tk[0], tv[0], torch.arange(S),
                                   kept, scale, window)
        assert torch.equal(again, got)


def _pages(seed, B, T, H, Hkv, D, ps, starts, dtype):
    rng = np.random.default_rng(seed)
    N = -(-(max(starts) + T) // ps) + 1
    P = 1 + B * N
    q, kp, vp = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, H, D), (P, ps, Hkv, D), (P, ps, Hkv, D)))
    if dtype == "bfloat16":
        kp, vp = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                  for a in (kp, vp))
    bt = np.zeros((B, N), np.int32)   # past the context: the scratch page
    for b, s in enumerate(starts):
        n = -(-(s + T) // ps)
        bt[b, :n] = 1 + b * N + rng.permutation(N)[:n]
    return q, kp, vp, bt, np.asarray(starts, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("starts,T,ps,n_split", [
    ((0, 64, 1024, 0), 64, 16, 6),    # the main path's tick, as split
    ((37, 300), 24, 24, 3),           # ranges end mid-page
    ((0, 500), 16, 16, 16),           # row 0: ranges past its horizon
])
def test_split_merge_matches_chunked_references(starts, T, ps, n_split,
                                                dtype):
    """Each row's key walk cut as the kernel cuts it: ceil(tiles /
    n_split) whole 64-key tiles a range, empty ranges at the end."""
    B, H, Hkv, D = len(starts), 9, 3, 64
    q, kp, vp, bt, sp = _pages(T + ps, B, T, H, Hkv, D, ps, starts, dtype)
    scale = D ** -0.5
    tq = torch.from_numpy(q)
    k = torch.from_numpy(kp)[torch.from_numpy(bt).long()].reshape(
        B, -1, Hkv, D)
    v = torch.from_numpy(vp)[torch.from_numpy(bt).long()].reshape(
        B, -1, Hkv, D)
    got = torch.empty(B, T, H, D)
    for b, s in enumerate(starts):
        kend = s + T
        ntile = -(-kend // KT)
        per = -(-ntile // n_split)
        bounds = [min(kend, i * per * KT) for i in range(n_split + 1)]
        got[b], _ = split_attention(tq[b], k[b], v[b], s + torch.arange(T),
                                    bounds, scale)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, sp)]
    want = tref.chunked_prefill_attention(*args, scale)
    torch.testing.assert_close(got, want, rtol=0, atol=SPLIT_TOL)
    jo = np.asarray(jref.chunked_prefill_attention(q, kp, vp, bt, sp, scale))
    np.testing.assert_allclose(got.numpy(), jo, rtol=0, atol=SPLIT_TOL)
    if starts == (0, 64, 1024, 0) and dtype == "float32":
        po = np.asarray(pallas_chunked(q, kp, vp, bt, sp, block_q=16))
        np.testing.assert_allclose(got.numpy(), po, rtol=0, atol=SPLIT_TOL)


@pytest.mark.parametrize("blocks,walk,want", [
    (48, 2048, 6),       # K2's tick: 4 rows x 3 kv heads x 4 q tiles
    (147, 1024, 2),      # K4 at smollm-135m: 3 kv heads x 49 q tiles
    (512, 2048, 1),      # recurrentgemma-9b: 512 q tiles of 4 tokens
    (312, 1024, 1),      # 8 rows of 256 tokens at smollm-135m's heads
    (6, 1536, 16),       # 2 rows of 16 tokens: at most 16 ranges
    (4, 100, 2),         # at most one range per 64 keys
])
def test_split_plan(blocks, walk, want):
    """The wrappers split a walk only where the grid of one range gives
    under two blocks an SM of an H100 (132 SMs)."""
    assert _build.prefill_split(blocks, walk, 132) == want


# ------------------------------------------------------ (b) the 3xTF32 split

def tf32_rn(x):
    """cvt.rna.tf32.f32: round the fp32 magnitude to 10 mantissa bits,
    ties away from zero (the sign bit is apart from the magnitude)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_cut(x):
    """The 13 low bits of an fp32 cleared: the kernel's lo operand."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def split_product(a, b, a_exact, b_exact, passes):
    """a (R, K) @ b (K, C) of fp32 values as the tensor cores take it:
    TF32 operands, exact products, summed in fp64; with 3 passes lo.hi' +
    hi.lo' + hi.hi' (hi = tf32_rn(x), lo = tf32_cut(x - hi), as the kernel
    splits), where an exact (bf16) side has no lo."""
    ah, bh = tf32_rn(a), tf32_rn(b)
    out = ah.astype(np.float64) @ bh.astype(np.float64)
    if passes == 1:
        return out
    if not a_exact:
        al = tf32_cut(a - ah)
        out += al.astype(np.float64) @ bh.astype(np.float64)
    if not b_exact:
        bl = tf32_cut(b - bh)
        out += ah.astype(np.float64) @ bl.astype(np.float64)
    return out


def emulated_attention(q, k, v, scale, kv_bf16, passes):
    """Causal attention of q (S, D) over k/v (S, D) with both products
    through ``split_product`` and p in fp32, as the kernel holds it."""
    S = q.shape[0]
    s = split_product(q, k.T, False, kv_bf16, passes) * scale
    s = np.where(np.tril(np.ones((S, S), bool)), s, NEG_INF)
    p = np.exp(s - s.max(-1, keepdims=True))
    l = p.sum(-1, keepdims=True)
    p = p.astype(np.float32)
    return split_product(p, v, False, kv_bf16, passes) / l


def test_tf32_rn_rounds_to_ten_mantissa_bits():
    x = np.asarray([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                    -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23], np.float32)
    want = np.asarray([1.0, 1 + 2 ** -10, 1 + 2 ** -10, 1 + 2 ** -9,
                       -(1 + 2 ** -10), 1.0], np.float32)
    np.testing.assert_array_equal(tf32_rn(x), want)
    # hi + lo carries ~22 significant bits; bf16 is exact in TF32
    a = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    hi = tf32_rn(a)
    lo = tf32_cut(a - hi)
    assert np.max(np.abs((hi.astype(np.float64) + lo - a) / a)) < 2 ** -21
    b = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(tf32_rn(b), b)


@pytest.mark.parametrize("S,D,kv_bf16", [
    (256, 64, False),    # smollm-135m heads, fp32 weights (K4): 3 passes
    (256, 64, True),     # bf16 pages (K2): 2 passes a product
    (128, 256, False),   # recurrentgemma-9b heads (K4)
])
def test_split_tf32_holds_the_kernel_tolerance(S, D, kv_bf16):
    q, k, v = _draw(D + S, (S, D), (S, D), (S, D))
    if kv_bf16:
        k, v = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                for a in (k, v))
    scale = D ** -0.5
    want = tref.flash_attention(*(torch.from_numpy(a)[None, :, None]
                                  for a in (q, k, v)), scale)[0, :, 0]
    want = want.double().numpy()
    err3 = np.abs(emulated_attention(q, k, v, scale, kv_bf16, 3)
                  - want).max()
    err1 = np.abs(emulated_attention(q, k, v, scale, kv_bf16, 1)
                  - want).max()
    assert err3 < KERNEL_TOL / 10, err3
    assert err1 > KERNEL_TOL, err1
