"""The plain versions of the dense-cache kernels (``decode_attention``,
K3, and ``flash_attention``, K4) against the reference's oracles in
``repro/kernels/ref.py``, and one case each against the Pallas kernel in
interpret mode.

Inputs are drawn with numpy from a seed and handed to both frameworks.
The sweeps cover GQA groups 1, 3 and 4, head_dim 32/64/128, lengths that
are not a multiple of 128, scalar and per-row fills, and bf16 caches.

Tolerances: both sides compute in fp32 from the same values (bf16 caches
widen to fp32 exactly), so they differ only in summation order: 2e-5,
ten times fp32 rounding on outputs of unit scale. A bf16 output is one
bf16 rounding of that: 1e-2.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jdecode_mod
from repro.kernels import flash_attention as jflash_mod
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}


def _draw(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
    return a


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np32(t):
    return t.float().numpy()


def _jflash(q, k, v, scale, causal, fn=jref.flash_attention, **kw):
    """The reference's (BH, S, D) oracle at the (B, S, H, D) layout, as
    ``repro.kernels.ops.flash_attention`` transposes for it."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    qf = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(B * H, Sq, D)
    kf = jnp.asarray(k).transpose(0, 2, 1, 3).reshape(B * Hkv, -1, D)
    vf = jnp.asarray(v).transpose(0, 2, 1, 3).reshape(B * Hkv, -1, D)
    o = fn(qf, kf, vf, scale, causal, **kw)
    return np.asarray(o.astype(jnp.float32)).reshape(
        B, H, Sq, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("qdt,kvdt", [("float32", "float32"),
                                      ("float32", "bfloat16"),
                                      ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal", [
    (2, 77, 77, 4, 4, 32, True),       # G 1
    (1, 130, 130, 9, 3, 64, True),     # G 3 (smollm-135m heads)
    (2, 45, 45, 32, 8, 128, True),     # G 4 (qwen3-4b heads)
    (1, 1, 1, 6, 2, 64, True),         # one token
    (2, 50, 37, 6, 2, 32, False),      # full attention, Sk != Sq
    (1, 20, 70, 8, 2, 64, True),       # more keys than queries
])
def test_plain_flash_matches_reference(B, Sq, Sk, H, Hkv, D, causal, qdt,
                                       kvdt):
    rng = np.random.default_rng(Sq * 131 + Sk)
    q = _draw(rng, (B, Sq, H, D), qdt)
    k, v = (_draw(rng, (B, Sk, Hkv, D), kvdt) for _ in range(2))
    scale = D ** -0.5
    want = _jflash(q, k.astype(q.dtype), v.astype(q.dtype), scale, causal)
    got = tref.flash_attention(_torch(q), _torch(k), _torch(v), scale,
                               causal)
    assert got.dtype == _torch(q).dtype and got.shape == q.shape
    np.testing.assert_allclose(_np32(got), want, **TOL[qdt])


@pytest.mark.parametrize("qdt,kvdt", [("float32", "float32"),
                                      ("float32", "bfloat16"),
                                      ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("B,S,H,Hkv,D,fills", [
    (2, 77, 4, 4, 32, (1, 77)),          # G 1, fill 1 and fill S
    (3, 300, 9, 3, 64, (130, 5, 299)),   # G 3
    (2, 45, 32, 8, 128, (44, 12)),       # G 4
])
def test_plain_decode_matches_reference(B, S, H, Hkv, D, fills, qdt, kvdt):
    """Per-row fills against the reference's scalar-fill oracle applied
    row by row (what the stacked batcher's vmap does), and a scalar fill
    against the oracle on the whole batch."""
    rng = np.random.default_rng(S * 17 + D)
    q = _draw(rng, (B, H, D), qdt)
    k, v = (_draw(rng, (B, S, Hkv, D), kvdt) for _ in range(2))
    scale = D ** -0.5
    tq, tk, tv = _torch(q), _torch(k), _torch(v)
    got = tref.decode_attention(tq, tk, tv,
                                torch.tensor(fills, dtype=torch.int32),
                                scale)
    assert got.dtype == tq.dtype and got.shape == q.shape
    for b, fill in enumerate(fills):
        want = np.asarray(jref.decode_attention(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
            jnp.asarray(v[b:b + 1]), fill, scale).astype(jnp.float32))
        np.testing.assert_allclose(_np32(got[b:b + 1]), want, **TOL[qdt])
    want = np.asarray(jref.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), fills[0],
        scale).astype(jnp.float32))
    np.testing.assert_allclose(
        _np32(tref.decode_attention(tq, tk, tv, fills[0], scale)), want,
        **TOL[qdt])


def test_plain_flash_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    B, S, H, Hkv, D = 1, 128, 4, 2, 32
    q = _draw(rng, (B, S, H, D), "float32")
    k, v = (_draw(rng, (B, S, Hkv, D), "float32") for _ in range(2))
    want = _jflash(q, k, v, D ** -0.5, True, fn=jflash_mod.flash_attention,
                   block_q=64, block_k=64, interpret=True)
    got = tref.flash_attention(_torch(q), _torch(k), _torch(v), D ** -0.5)
    np.testing.assert_allclose(_np32(got), want, **TOL["float32"])


def test_plain_decode_matches_pallas_interpret():
    rng = np.random.default_rng(4)
    B, S, H, Hkv, D = 2, 256, 6, 2, 64
    q = _draw(rng, (B, H, D), "float32")
    k, v = (_draw(rng, (B, S, Hkv, D), "bfloat16") for _ in range(2))
    want = np.asarray(jdecode_mod.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 130, D ** -0.5,
        block_k=128, interpret=True))
    got = tref.decode_attention(_torch(q), _torch(k), _torch(v), 130,
                                D ** -0.5)
    np.testing.assert_allclose(_np32(got), want, **TOL["float32"])


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers return their plain version's result and
    launch nothing."""
    rng = np.random.default_rng(5)
    q = _torch(_draw(rng, (2, 30, 6, 32), "float32"))
    k, v = (_torch(_draw(rng, (2, 30, 2, 32), "bfloat16"))
            for _ in range(2))
    n3, n4 = decode_attention.launches, flash_attention.launches
    assert torch.equal(flash_attention(q, k, v),
                       tref.flash_attention(q, k, v, 32 ** -0.5))
    lens = torch.tensor([3, 30], dtype=torch.int32)
    assert torch.equal(decode_attention(q[:, 0], k, v, lens),
                       tref.decode_attention(q[:, 0], k, v, lens,
                                             32 ** -0.5))
    assert (decode_attention.launches, flash_attention.launches) == (n3, n4)
