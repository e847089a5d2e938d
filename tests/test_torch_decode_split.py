"""The numeric ideas of the decode walk (K1 ``paged_decode_attention``,
K3 ``decode_attention``, ``src/repro_torch/csrc/decode_walk.cuh``),
modelled in plain PyTorch and numpy so that the CPU checks the design's
arithmetic:

(a) The split key walk. Each row's live keys are cut into key tiles (64
    keys; 32 for fp32 K/V at head_dim 256),
    and the tiles into n_split near-equal runs of whole tiles (the first
    ``tiles % n_split`` runs one tile longer), cut from that row's own
    fill. Each run gives its unnormalised (m, l, acc) under the kernels'
    rules (masked logits at the finite ``NEG_INF``, a masked key's p set
    to 0 outright, so a run past the fill is (NEG_INF, 0, 0)), and the
    runs merge in run order: m = max m_i, l = sum l_i e^(m_i - m), o =
    sum acc_i e^(m_i - m) / max(l, 1e-30). The merged output must match
    the port's plain versions and the JAX reference
    (``repro.kernels.ref``; its dense decode takes one scalar fill, so per
    row) within the fp32 tolerance of tests/test_torch_dense_kernels.py,
    2e-5: both sides compute in fp32 from the same values and differ only
    in summation order and exp's last bits.

(b) The split plan at the decode shapes: the rule of the prefill walk
    (``_build.prefill_split``) at the decode walk's key tile.

(c) The 3xTF32 split at decode: with bf16 K/V (exact in TF32) both
    products take two passes (q and P are fp32), emulated as the kernel
    rounds its operands; the output holds to a tenth of the kernels'
    ``KERNEL_TOL``, while one pass of TF32 misses it on a short row.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref
from test_torch_prefill_split import KERNEL_TOL, merge, split_product

NEG_INF = tref.NEG_INF
KT = 64                 # keys a tile of the decode walk (bf16 K/V)
SPLIT_TOL = 2e-5        # tests/test_torch_dense_kernels.py, fp32


def run_bounds(fill, n_split, kt=KT):
    """The key bounds of a row's n_split runs, as the kernel cuts them:
    whole ``kt``-key tiles of the live keys, near-equal runs, empty runs
    last."""
    ntile = -(-fill // kt)
    per, extra = divmod(ntile, n_split)
    bounds, t = [0], 0
    for s in range(n_split):
        t += per + (s < extra)
        bounds.append(min(fill, t * kt))
    return bounds


def run_partial(q, k, v, lo, hi, scale):
    """One run [lo, hi) of keys for the query heads q (G, D) over k/v
    (S, D): the unnormalised (m, l, acc), (NEG_INF, 0, 0) for an empty
    run."""
    G, D = q.shape
    if hi <= lo:
        return (torch.full((G,), NEG_INF), torch.zeros(G),
                torch.zeros(G, D))
    s = (q @ k[lo:hi].T) * scale
    m = s.max(dim=-1).values
    p = torch.exp(s - m[:, None])
    return m, p.sum(-1), p @ v[lo:hi]


def split_decode(q, k, v, fills, n_split, scale, kt=KT):
    """q (B, H, D) over k/v (B, S, Hkv, D), row b attending its first
    fills[b] keys, each kv head's query heads walked in n_split runs of
    ``kt``-key tiles and merged in order; returns the output and every
    run's partials."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    out = torch.empty(B, H, D)
    parts_all = []
    for b, fill in enumerate(fills):
        bounds = run_bounds(fill, n_split, kt)
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G]
            parts = [run_partial(qg, k[b, :, h], v[b, :, h], lo, hi, scale)
                     for lo, hi in zip(bounds[:-1], bounds[1:])]
            out[b, h * G:(h + 1) * G] = merge(parts)
            parts_all.append((bounds, parts))
    return out, parts_all


CASES = [
    # fills, H, Hkv, D, n_split, key tile
    ((1, 1, 1), 4, 4, 32, 8, 64),            # fills of 1, G 1: runs 1.. empty
    ((64, 128, 192), 12, 4, 128, 3, 64),     # fills on run boundaries, G 3
    ((65, 5), 32, 2, 128, 16, 64),           # most runs empty, G 16
    ((1, 16, 17, 300, 1024, 1, 1600, 32), 9, 3, 64, 11, 64),  # main path
    ((1600,), 9, 3, 64, 16, 64),             # the phone island
    ((2048, 1, 700), 16, 1, 256, 16, 64),    # recurrentgemma-9b, G 16
    ((2048, 33, 64), 16, 1, 256, 16, 32),    # ... fp32 K/V: 32-key tiles
    ((300, 33, 1, 128), 32, 8, 128, 5, 64),  # qwen3-4b heads, G 4
    ((7, 200), 8, 8, 32, 3, 64),             # G 1
]


def _draw(seed, B, S, H, Hkv, D, bf16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    if bf16:
        k, v = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                for a in (k, v))
    return q, k, v


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fills,H,Hkv,D,n_split,kt", CASES)
def test_split_decode_matches_dense_references(fills, H, Hkv, D, n_split,
                                               kt, bf16):
    B, S = len(fills), max(fills) + 5
    q, k, v = _draw(S + H + D, B, S, H, Hkv, D, bf16)
    scale = D ** -0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got, parts = split_decode(tq, tk, tv, fills, n_split, scale, kt)
    lens = torch.tensor(fills, dtype=torch.int32)
    want = tref.decode_attention(tq, tk, tv, lens, scale)
    torch.testing.assert_close(got, want, rtol=0, atol=SPLIT_TOL)
    for b, fill in enumerate(fills):       # the reference's scalar fill
        jo = np.asarray(jref.decode_attention(q[b:b + 1], k[b:b + 1],
                                              v[b:b + 1], fill, scale))
        np.testing.assert_allclose(got[b:b + 1].numpy(), jo, rtol=0,
                                   atol=SPLIT_TOL)
    # a run past the fill adds exactly nothing, and dropping it changes
    # no bit of the merge
    for bounds, hparts in parts:
        for (lo, hi), (m, l, acc) in zip(zip(bounds[:-1], bounds[1:]),
                                         hparts):
            if hi <= lo:
                assert torch.all(m == NEG_INF)
                assert torch.all(l == 0) and torch.all(acc == 0)
        kept = [p for (lo, hi), p in zip(zip(bounds[:-1], bounds[1:]),
                                         hparts) if hi > lo]
        assert torch.equal(merge(kept), merge(hparts))


def _paged(k, v, fills, ps, seed):
    """The dense rows laid out over shuffled pages of a pool whose page 0
    is the scratch page (table entries past a row's fill point at it)."""
    B, S, Hkv, D = k.shape
    N = -(-S // ps)
    P = 1 + B * N
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    bt = np.zeros((B, N), np.int32)
    for b, fill in enumerate(fills):
        n = -(-fill // ps)
        bt[b, :n] = 1 + b * N + rng.permutation(N)[:n]
        for i in range(n):
            rows = slice(i * ps, min((i + 1) * ps, fill))
            kp[bt[b, i], :rows.stop - rows.start] = k[b, rows]
            vp[bt[b, i], :rows.stop - rows.start] = v[b, rows]
    return kp, vp, bt


@pytest.mark.parametrize("ps", [16, 8])
@pytest.mark.parametrize("fills,H,Hkv,D,n_split,kt", CASES[:5])
def test_split_decode_matches_paged_references(fills, H, Hkv, D, n_split,
                                               kt, ps):
    B, S = len(fills), max(fills) + 5
    q, k, v = _draw(S + D + ps, B, S, H, Hkv, D, True)
    kp, vp, bt = _paged(k, v, fills, ps, S)
    scale = D ** -0.5
    got, _ = split_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                          fills, n_split, scale, kt)
    lens = np.asarray(fills, np.int32)
    want = tref.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, lens)), scale)
    torch.testing.assert_close(got, want, rtol=0, atol=SPLIT_TOL)
    jo = np.asarray(jref.paged_decode_attention(q, kp, vp, bt, lens, scale))
    np.testing.assert_allclose(got.numpy(), jo, rtol=0, atol=SPLIT_TOL)


def test_runs_are_near_equal_and_cover_the_fill():
    """Every run is a whole number of tiles (the last one cut at the
    fill), runs differ by at most one tile, and a short row's runs past
    its tiles are empty."""
    for kt in (32, 64):
        for fill in (1, 31, 32, 33, 64, 65, 100, 1600, 2048):
            for n_split in (1, 2, 5, 11, 16):
                b = run_bounds(fill, n_split, kt)
                assert b[0] == 0 and b[-1] == fill
                assert len(b) == n_split + 1
                tiles = [-(-(hi - lo) // kt)
                         for lo, hi in zip(b[:-1], b[1:])]
                assert max(tiles) - min(tiles) <= 1
                assert all(lo % kt == 0 for lo in b[:-1] if lo < fill)
    # 25 tiles of 64 in 11 runs: 3 of 3 tiles, then 8 of 2
    assert run_bounds(1600, 11)[1:5] == [192, 384, 576, 704]
    assert run_bounds(17, 16)[1:] == [17] * 16


@pytest.mark.parametrize("blocks,walk,tile,want", [
    (24, 2048, 64, 11),  # the main path's largest island: 8 rows x 3 heads
    (3, 2048, 64, 16),   # the phone island: 1 row x 3 kv heads
    (8, 2048, 64, 16),   # recurrentgemma-9b: 8 rows x 1 kv head of G 16
    (64, 2048, 64, 5),   # qwen3-4b heads: 8 rows x 8 kv heads
    (18, 2048, 64, 15),  # the laptop island: 6 rows x 3 kv heads
    (3, 256, 64, 4),     # at most one range per key tile
    (3, 256, 32, 8),     # ... of 32 keys (fp32 K/V at head_dim 256)
])
def test_decode_split_plan(blocks, walk, tile, want):
    """The decode walk splits only where its grid of one range gives under
    two blocks an SM of an H100 (132 SMs), at most one range per key tile
    of the cap, and at most 16."""
    assert _build.prefill_split(blocks, walk, 132, tile) == want


def emulated_decode(q, k, v, scale, passes):
    """One row's decode of q (G, D) over k/v (S, D) bf16 values, both
    products through ``split_product`` (q and P fp32, K/V exact), p in
    fp32 as the kernel holds it."""
    s = split_product(q, k.T, False, True, passes) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    l = p.sum(-1, keepdims=True)
    return split_product(p.astype(np.float32), v, False, True, passes) / l


@pytest.mark.parametrize("G,D,S,one_pass_misses", [
    (3, 64, 2, True),          # smollm-135m heads, a two-token row
    (3, 64, 1600, False),      # ... the main path's longest row
    (16, 256, 5, True),        # recurrentgemma-9b heads, a short row
    (16, 256, 2048, False),    # ... its whole ring
    (4, 128, 2, True),         # qwen3-4b heads
    (4, 128, 300, False),
])
def test_split_tf32_holds_the_kernel_tolerance_at_decode(G, D, S,
                                                         one_pass_misses):
    """Two passes hold every row to a tenth of ``KERNEL_TOL``; one pass
    misses it on a short row, where a few keys carry all the weight (over
    a long row its roundings average out)."""
    q, k, v = (np.random.default_rng(D + S).standard_normal(s)
               .astype(np.float32) for s in ((G, D), (S, D), (S, D)))
    k, v = (a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in (k, v))
    scale = D ** -0.5
    tk, tv = (torch.from_numpy(a)[None, :, None] for a in (k, v))
    want = tref.decode_attention(torch.from_numpy(q)[None], tk, tv, S,
                                 scale)[0].double().numpy()
    err2 = np.abs(emulated_decode(q, k, v, scale, 2) - want).max()
    assert err2 < KERNEL_TOL / 10, err2
    if one_pass_misses:
        err1 = np.abs(emulated_decode(q, k, v, scale, 1) - want).max()
        assert err1 > KERNEL_TOL, err1
