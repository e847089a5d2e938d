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
  row: a window of 1, a single token) the port's dP - D leaves ~2e-7.
* The formulas against autograd through the plain forward, with and
  without causal masking, and with Sq != Sk.
* The kernel's walks (``csrc/flash_attention_bwd.cu``), modelled here tile
  for tile: the q tiles a dK/dV block walks and the key tiles a dQ block
  walks cover every pair the mask allows, and each tile walked holds at
  least one such pair, at every tile size the kernel compiles.
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

# (BQ, BK) by head_dim, as BwdTiles in csrc/flash_attention_bwd.cu
TILES = {32: (64, 64), 64: (64, 64), 128: (32, 64), 256: (32, 32)}


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


@pytest.mark.parametrize("D", sorted(TILES))
def test_kernel_walks_cover_exactly_the_allowed_tiles(D):
    BQ, BK = TILES[D]
    for Sq, Sk, causal, window, prefix in itertools.product(
            (1, 31, 32, 33, 64, 65, 127, 200), (1, 33, 64, 130, 200),
            (True, False), (None, 1, 20, 64, 100), (0, 1, 33, 64, 300)):
        if window and not causal:
            continue
        ok = _allowed(Sq, Sk, causal, window, prefix)
        nqt, nkt = -(-Sq // BQ), -(-Sk // BK)
        tile_ok = np.zeros((nqt, nkt), bool)
        for qt in range(nqt):
            for kt in range(nkt):
                tile_ok[qt, kt] = ok[qt * BQ:(qt + 1) * BQ,
                                     kt * BK:(kt + 1) * BK].any()
        by_key = np.zeros_like(tile_ok)
        for kt in range(nkt):
            for qt in _dkdv_q_tiles(kt * BK, min(BK, Sk - kt * BK), Sq, BQ,
                                    causal, window, prefix):
                by_key[qt, kt] = True
        by_q = np.zeros_like(tile_ok)
        for qt in range(nqt):
            for kt in _dq_key_tiles(qt * BQ, min(BQ, Sq - qt * BQ), Sk, BK,
                                    causal, window, prefix):
                by_q[qt, kt] = True
        case = (D, Sq, Sk, causal, window, prefix)
        # every allowed pair's tile is walked by both kernels
        assert not (tile_ok & ~by_key).any(), case
        assert not (tile_ok & ~by_q).any(), case
        # and the dK/dV walk takes no tile without an allowed pair
        assert not (by_key & ~tile_ok).any(), case


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
