"""K4's backward on the CPU: ``ref.flash_attention_bwd`` and the autograd
Function around K4 (``kernels.flash_attention.FlashAttention``, which takes
the plain versions on CPU tensors) against ``jax.vjp`` of the reference's
``attend_naive`` (``repro/models/attention.py:38``), the attention the
reference's train step differentiates.

* Causal, local-window and prefix-LM masks (and a window with a prefix),
  GQA (G 1, 3, 4, 8), head_dim 32, 64 and 256, and ragged lengths (1, 37,
  65, 130). Both sides are fp32 and differ in summation order only: each
  gradient holds to 2e-5 of its largest magnitude, or of 1 where that is
  smaller: the inputs are unit normals, so dP and D are of order 1, and
  where a gradient cancels to an exact zero in the reference (one key a
  row: a window of 1, a single token) the port's is exactly zero too (D
  is sum_j softmax(S)_ij dP_ij, so dP - D is 0 for a one-key row).
* The formulas against autograd through the plain forward, with and
  without causal masking, and with Sq != Sk.
* The kernel's walks (``csrc/flash_attention_bwd.cu``), modelled here tile
  for tile: the query steps a dK/dV block walks and the key steps a dQ
  block walks cover every pair the mask allows, and each step of the
  dK/dV walk holds at least one such pair, at every tile size the kernel
  compiles.
* The kernel's arithmetic: its products in 3xTF32 (fp32 operands split
  into TF32 hi and lo, lo.hi' + hi.lo' + hi.hi', each k step added in
  fp32), D from the softmax of its own scores and its dP, modelled with
  ``split_product`` of
  tests/test_torch_prefill_split.py, hold ``chip_smoke.py``'s BWD_TOL
  (1e-4 of each gradient's largest) against the plain version at
  smollm-135m's, paligemma-3b's and recurrentgemma-9b's head dims and
  masks; one TF32 pass misses it.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attend_naive
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from test_torch_prefill_split import split_product

# (B, S, H, Hkv, D, window, prefix)
CASES = [
    (2, 37, 6, 2, 32, None, 0),        # ragged, G 3
    (1, 65, 4, 4, 64, None, 0),        # one past a tile, G 1
    (2, 130, 8, 1, 256, None, 40),     # paligemma heads (G 8), a prefix
    (1, 130, 8, 2, 64, 33, 0),         # a ragged window
    (1, 65, 8, 2, 64, 1, 0),           # window of 1
    (1, 130, 4, 1, 32, 20, 50),        # a window and a prefix
    (1, 37, 4, 2, 64, None, 500),      # a prefix past the prompt
    (1, 1, 4, 2, 32, None, 0),         # one token
]


def _inputs(seed, B, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    do = rng.standard_normal((B, S, H, D), np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, window, prefix):
    S, D = q.shape[1], q.shape[-1]
    pos = jnp.arange(S)
    f = lambda q, k, v: attend_naive(q, k, v, pos, pos, D ** -0.5, window,
                                     prefix)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want, rel=2e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1.0), err


@pytest.mark.parametrize("B,S,H,Hkv,D,window,prefix", CASES)
def test_plain_backward_matches_jax_vjp(B, S, H, Hkv, D, window, prefix):
    q, k, v, do = _inputs(S + D + prefix, B, S, H, Hkv, D)
    want = _jax_grads(q, k, v, do, window, prefix)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = ref.flash_attention(tq, tk, tv, D ** -0.5, True, window,
                                 prefix, return_lse=True)
    got = ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, D ** -0.5, True,
                                  window, prefix)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("B,S,H,Hkv,D,window,prefix", CASES)
def test_autograd_function_matches_jax_vjp(B, S, H, Hkv, D, window, prefix):
    """The Function the model's full mode runs: ``flash_attention`` on
    inputs that require grad, differentiated by autograd."""
    q, k, v, do = _inputs(S * 3 + D + prefix, B, S, H, Hkv, D)
    want = _jax_grads(q, k, v, do, window, prefix)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = flash_attention(tq, tk, tv, window=window, prefix_len=prefix)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal,Sq,Sk", [(True, 40, 40), (False, 40, 40),
                                          (False, 30, 50), (True, 50, 30),
                                          (True, 30, 50)])
def test_formulas_match_autograd_of_the_plain_forward(causal, Sq, Sk):
    rng = np.random.default_rng(Sq * Sk)
    q = torch.from_numpy(rng.standard_normal((2, Sq, 6, 32), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, Sk, 2, 32), np.float32))
            for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((2, Sq, 6, 32), np.float32))
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.flash_attention(*live, 32 ** -0.5, causal)
    want = torch.autograd.grad(out, live, do)
    o, lse = ref.flash_attention(q, k, v, 32 ** -0.5, causal,
                                 return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, 32 ** -0.5, causal)
    for g, w in zip(got, want):
        _close(g, w.numpy())


def test_bf16_gradients_come_back_in_bf16():
    q, k, v, do = _inputs(5, 1, 37, 4, 2, 64)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
                  for a in (q, k, v))
    out = flash_attention(tq, tk, tv)
    got = torch.autograd.grad(out, (tq, tk, tv),
                              torch.from_numpy(do).to(torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 for g in got)


# ---------------------------------------------- the kernel's walks, modelled

# by head_dim, as BwdTiles and BW_ROWS in csrc/flash_attention_bwd.cu:
# (keys a dK/dV block, query rows a dK/dV step, query rows a dQ block,
# keys a dQ step)
TILES = {32: (64, 32, 64, 32), 64: (64, 32, 64, 32), 128: (64, 16, 64, 16),
         256: (64, 16, 64, 16)}


def _allowed(Sq, Sk, causal, window, prefix):
    t = np.arange(Sq)[:, None]
    j = np.arange(Sk)[None, :]
    if not causal:
        return np.ones((Sq, Sk), bool)
    ok = j <= t
    if window:
        ok &= j > t - window
    return ok | (j < prefix)


def _dkdv_q_tiles(k0, nk, Sq, BQ, causal, window, prefix):
    """flash_bwd_dkdv_kernel's q tiles for the key tile at k0."""
    qlo, qhi = 0, Sq
    if causal and k0 >= prefix:
        qlo = min(k0, Sq)
        if window:
            qhi = min(Sq, k0 + nk - 1 + window)
    lo = qlo // BQ
    hi = -(-qhi // BQ) if qhi > qlo else lo
    return range(lo, hi)


def _dq_key_tiles(t0, nq, Sk, BK, causal, window, prefix):
    """flash_bwd_dq_kernel's key tiles for the q tile at t0."""
    kend = min(Sk, max(t0 + nq, prefix)) if causal else Sk
    kbeg = (max(0, t0 - window + 1) // BK * BK
            if causal and window and not prefix else 0)
    return range(kbeg // BK, -(-kend // BK) if kend > kbeg else kbeg // BK)


def _tiles_allowed(ok, rows, cols):
    """Which (rows x cols) tiles of the pair mask ``ok`` hold an allowed
    pair."""
    nr, nc = -(-ok.shape[0] // rows), -(-ok.shape[1] // cols)
    return np.array([[ok[r * rows:(r + 1) * rows,
                         c * cols:(c + 1) * cols].any()
                      for c in range(nc)] for r in range(nr)], bool)


@pytest.mark.parametrize("D", sorted(TILES))
def test_kernel_walks_cover_exactly_the_allowed_tiles(D):
    KB, QS, QB, KS = TILES[D]
    for Sq, Sk, causal, window, prefix in itertools.product(
            (1, 15, 17, 31, 32, 33, 64, 65, 127, 200),
            (1, 17, 33, 64, 130, 200),
            (True, False), (None, 1, 20, 64, 100), (0, 1, 33, 64, 300)):
        if window and not causal:
            continue
        ok = _allowed(Sq, Sk, causal, window, prefix)
        case = (D, Sq, Sk, causal, window, prefix)
        # the dK/dV walk: query steps of QS rows for blocks of KB keys
        tile_ok = _tiles_allowed(ok, QS, KB)
        by_key = np.zeros_like(tile_ok)
        for kt in range(tile_ok.shape[1]):
            for qt in _dkdv_q_tiles(kt * KB, min(KB, Sk - kt * KB), Sq, QS,
                                    causal, window, prefix):
                by_key[qt, kt] = True
        # every allowed pair's tile is walked, and no tile without one
        assert not (tile_ok & ~by_key).any(), case
        assert not (by_key & ~tile_ok).any(), case
        # the dQ walk: key steps of KS keys for blocks of QB query rows
        tile_ok = _tiles_allowed(ok, QB, KS)
        by_q = np.zeros_like(tile_ok)
        for qt in range(tile_ok.shape[0]):
            for kt in _dq_key_tiles(qt * QB, min(QB, Sq - qt * QB), Sk, KS,
                                    causal, window, prefix):
                by_q[qt, kt] = True
        assert not (tile_ok & ~by_q).any(), case


@pytest.mark.parametrize("blocks,G,sms,want", [
    (768, 3, 132, 1),     # smollm's train step: 32 key tiles x 3 x 8 rows
    (32, 8, 132, 8),      # paligemma's: 16 x 1 x 2, every head its block
    (64, 16, 132, 4),     # recurrentgemma's heads at S 2048: 5 -> 4 of 4
    (40, 6, 132, 6),
    (263, 4, 132, 2),     # one short of two blocks an SM
    (264, 4, 132, 1),
    (10, 1, 132, 1),      # G 1: nothing to split
])
def test_backward_head_split_plan(blocks, G, sms, want):
    from repro_torch.kernels.flash_attention import bwd_split
    assert bwd_split(blocks, G, sms) == want


# ------------------------------------------ the kernel's arithmetic, modelled

# chip_smoke.py's BWD_TOL: each gradient to 1e-4 of its largest magnitude
BWD_TOL = 1e-4


def _split_backward(q, k, v, o, lse, do, scale, window, prefix, passes):
    """The backward kernel's arithmetic on one batch row, causal: q, o, do
    (S, H, D), k, v (S, Hkv, D), lse (S, H). Every product (S, dP, dV, dK,
    dQ) through ``split_product`` at ``passes`` TF32 passes; P, D (the
    softmax of the scores times dP, summed) and dS in fp32, as the kernel
    holds them."""
    S, H, _ = q.shape
    G = H // k.shape[1]
    ok = _allowed(S, S, True, window, prefix)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for h in range(H):
        qh, kh, vh, doh = q[:, h], k[:, h // G], v[:, h // G], do[:, h]
        s = split_product(qh, kh.T, False, False, passes).astype(np.float32)
        p = np.where(ok, np.exp(s * np.float32(scale) - lse[:, h, None]),
                     0).astype(np.float32)
        dp = split_product(doh, vh.T, False, False, passes).astype(
            np.float32)
        sc = np.where(ok, s * np.float32(scale), -np.inf)
        e = np.exp(sc - sc.max(-1, keepdims=True)).astype(np.float32)
        dsum = ((e * dp).sum(-1, dtype=np.float32)
                / e.sum(-1, dtype=np.float32))
        ds = (p * (dp - dsum[:, None])).astype(np.float32)
        dv[:, h // G] += split_product(p.T, doh, False, False, passes)
        dk[:, h // G] += split_product(ds.T, qh, False, False,
                                       passes) * scale
        dq[:, h] = split_product(ds, kh, False, False, passes) * scale
    return dq, dk, dv


@pytest.mark.parametrize("S,H,Hkv,D,window,prefix", [
    (80, 3, 1, 64, None, 0),       # smollm-135m's heads (G 3), causal
    (48, 2, 1, 256, None, 16),     # paligemma-3b's: D 256, a prefix
    (40, 4, 1, 256, 20, 0),        # recurrentgemma-9b's: a window
])
def test_split_tf32_backward_holds_bwd_tol(S, H, Hkv, D, window, prefix):
    q, k, v, do = (a[0] for a in _inputs(S + D, 1, S, H, Hkv, D))
    scale = D ** -0.5
    tq, tk, tv, tdo = (torch.from_numpy(a)[None] for a in (q, k, v, do))
    o, lse = ref.flash_attention(tq, tk, tv, scale, True, window, prefix,
                                 return_lse=True)
    want = [w[0].numpy() for w in ref.flash_attention_bwd(
        tq, tk, tv, o, lse, tdo, scale, True, window, prefix)]
    errs = {}
    for passes in (3, 1):
        got = _split_backward(q, k, v, o[0].numpy(), lse[0].numpy(), do,
                              scale, window, prefix, passes)
        errs[passes] = [float(np.abs(g - w).max()) / float(np.abs(w).max())
                        for g, w in zip(got, want)]
    # three passes: each gradient within a tenth of the tolerance
    assert max(errs[3]) < BWD_TOL / 10, errs[3]
    # one pass (operands rounded to TF32): ~1e-3 of each gradient
    assert min(errs[1]) > BWD_TOL, errs[1]
