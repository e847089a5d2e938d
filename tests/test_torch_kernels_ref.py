"""The port's paged attention (plain versions, and the kernel wrappers on
CPU tensors) against the reference's oracles in ``repro.kernels.ref``.

Inputs are drawn once with numpy and handed to both frameworks. fp32
cases hold to 1e-5: both sides compute in fp32 and differ only in
summation order. bf16 cases (bf16 q and pages, bf16 output) hold to 2e-2,
one bf16 rounding of the output. One case per kernel also runs the
reference's Pallas kernel in interpret mode, as ``tests/test_kernels.py``
runs it.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.chunked_prefill import \
    chunked_prefill_attention as pallas_chunked
from repro.kernels.paged_attention import \
    paged_decode_attention as pallas_paged
from _torch_parity import other_device
from repro_torch.kernels import ref as tref
from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
from repro_torch.kernels.paged_attention import paged_decode_attention

# one compiled program per case instead of one per eager op
JREF_PAGED = jax.jit(jref.paged_decode_attention, static_argnums=5)
JREF_CHUNKED = jax.jit(jref.chunked_prefill_attention, static_argnums=5)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _arrays(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        out = [a.astype(ml_dtypes.bfloat16) for a in out]
    return out


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want),
                               **(BF16_TOL if dtype == "bfloat16"
                                  else F32_TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,P,ps,N,D,valids", [
    (2, 8, 2, 24, 16, 8, 64, (1, 128)),        # near-empty + full
    (1, 4, 1, 9, 8, 4, 64, (17,)),             # mid-page ragged fill
    (3, 6, 6, 12, 16, 3, 64, (5, 31, 48)),     # per-sequence ragged levels
    (2, 16, 4, 40, 32, 6, 64, (100, 192)),     # larger pages
    (4, 9, 3, 20, 16, 5, 64, (1, 16, 17, 80)),  # smollm-135m heads, page edge
])
def test_paged_decode_matches_reference(B, H, Hkv, P, ps, N, D, valids,
                                        dtype):
    q, kp, vp = _arrays(B * 100 + N, [(B, H, D), (P, ps, Hkv, D),
                                      (P, ps, Hkv, D)], dtype)
    bt = np.random.default_rng(3).integers(0, P, (B, N)).astype(np.int32)
    valid = np.asarray(valids, np.int32)
    want = JREF_PAGED(q, kp, vp, bt, valid, D ** -0.5)
    got = tref.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                      _t(valid), D ** -0.5)
    _check(got, want, dtype)
    n0 = paged_decode_attention.launches
    wrapped = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                     _t(valid))
    assert paged_decode_attention.launches == n0   # CPU: plain version
    assert torch.equal(wrapped, got)


def test_paged_decode_matches_pallas_interpret():
    B, H, Hkv, P, ps, N, D = 3, 9, 3, 10, 16, 4, 64
    q, kp, vp = _arrays(7, [(B, H, D), (P, ps, Hkv, D), (P, ps, Hkv, D)],
                        "float32")
    bt = np.random.default_rng(8).integers(1, P, (B, N)).astype(np.int32)
    valid = np.asarray([1, 33, 64], np.int32)
    want = pallas_paged(q, kp, vp, bt, valid)
    got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(valid))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)


def test_paged_matches_dense_on_contiguous_table():
    """A contiguous block table over the pool IS the dense cache."""
    B, H, Hkv, D, P, ps, N = 2, 8, 2, 32, 8, 16, 8
    q, kp, vp = _arrays(1, [(B, H, D), (P, ps, Hkv, D), (P, ps, Hkv, D)],
                        "float32")
    bt = np.tile(np.arange(N, dtype=np.int32)[None], (B, 1))
    k_dense = np.broadcast_to(kp.reshape(1, N * ps, Hkv, D),
                              (B, N * ps, Hkv, D))
    v_dense = np.broadcast_to(vp.reshape(1, N * ps, Hkv, D),
                              (B, N * ps, Hkv, D))
    got = tref.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                      torch.full((B,), 77, dtype=torch.int32),
                                      D ** -0.5)
    want = jref.decode_attention(q, k_dense, v_dense, 77, D ** -0.5)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_paged_scratch_pages_fully_masked():
    """Table entries past the fill level point at the scratch page;
    whatever lives there must never reach the output (exact)."""
    B, H, Hkv, D, P, ps, N = 1, 9, 3, 64, 6, 16, 4
    q, kp, vp = (_t(a) for a in _arrays(
        2, [(B, H, D), (P, ps, Hkv, D), (P, ps, Hkv, D)], "float32"))
    bt = torch.tensor([[3, 0, 0, 0]], dtype=torch.int32)
    valid = torch.tensor([9], dtype=torch.int32)
    o1 = tref.paged_decode_attention(q, kp, vp, bt, valid, D ** -0.5)
    kp[0], vp[0] = 1e4, -1e4                  # poison the scratch page
    o2 = tref.paged_decode_attention(q, kp, vp, bt, valid, D ** -0.5)
    assert torch.equal(o1, o2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,P,ps,N,T,D,starts", [
    (1, 4, 2, 8, 16, 4, 16, 32, (16,)),        # one-page chunk mid-sequence
    (2, 8, 2, 12, 16, 6, 32, 32, (0, 48)),     # 2-page chunk
    (1, 4, 4, 6, 8, 6, 16, 32, (24,)),         # small pages, MHA
    (2, 16, 4, 16, 16, 8, 64, 32, (32, 0)),    # long chunk, ragged starts
    (3, 9, 3, 20, 16, 6, 32, 64, (0, 16, 64)),  # smollm-135m heads
])
def test_chunked_prefill_matches_reference(B, H, Hkv, P, ps, N, T, D,
                                           starts, dtype):
    q, kp, vp = _arrays(B * 10 + T, [(B, T, H, D), (P, ps, Hkv, D),
                                     (P, ps, Hkv, D)], dtype)
    bt = np.random.default_rng(3).integers(0, P, (B, N)).astype(np.int32)
    sp = np.asarray(starts, np.int32)
    want = JREF_CHUNKED(q, kp, vp, bt, sp, D ** -0.5)
    got = tref.chunked_prefill_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                         _t(sp), D ** -0.5)
    _check(got, want, dtype)
    n0 = chunked_prefill_attention.launches
    wrapped = chunked_prefill_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                        _t(sp))
    assert chunked_prefill_attention.launches == n0
    assert torch.equal(wrapped, got)


def test_chunked_prefill_matches_pallas_interpret():
    B, H, Hkv, P, ps, N, T, D = 2, 9, 3, 10, 16, 4, 32, 64
    q, kp, vp = _arrays(9, [(B, T, H, D), (P, ps, Hkv, D), (P, ps, Hkv, D)],
                        "float32")
    bt = np.random.default_rng(10).integers(1, P, (B, N)).astype(np.int32)
    sp = np.asarray([0, 32], np.int32)
    want = pallas_chunked(q, kp, vp, bt, sp, block_q=16)
    got = chunked_prefill_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(sp))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)


def test_chunked_prefill_replays_monolithic_flash():
    """Chunk-sized pieces against a contiguous block table reproduce the
    reference's monolithic causal attention row for row."""
    B, H, Hkv, D, ps, N = 1, 4, 2, 32, 16, 4
    S = N * ps
    q, k, v = _arrays(11, [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)],
                      "float32")
    kp = k[0].reshape(N, ps, Hkv, D)
    vp = v[0].reshape(N, ps, Hkv, D)
    bt = np.arange(N, dtype=np.int32)[None]
    qf = q.transpose(0, 2, 1, 3).reshape(B * H, S, D)
    kf = k.transpose(0, 2, 1, 3).reshape(B * Hkv, S, D)
    vf = v.transpose(0, 2, 1, 3).reshape(B * Hkv, S, D)
    o_full = np.asarray(jref.flash_attention(qf, kf, vf, D ** -0.5))
    o_full = o_full.reshape(B, H, S, D).transpose(0, 2, 1, 3)
    for t in range(N):
        got = tref.chunked_prefill_attention(
            _t(q[:, t * ps:(t + 1) * ps]), _t(kp), _t(vp),
            _t(np.ascontiguousarray(bt[:, :t + 1])),
            torch.tensor([t * ps], dtype=torch.int32), D ** -0.5)
        np.testing.assert_allclose(_np(got), o_full[:, t * ps:(t + 1) * ps],
                                   rtol=1e-5, atol=1e-5)


def test_chunked_prefill_future_pages_fully_masked():
    """Block-table entries past the chunk's causal horizon (scratch refs)
    never reach the output (exact)."""
    B, H, Hkv, D, P, ps, N = 1, 9, 3, 64, 6, 16, 4
    q, kp, vp = (_t(a) for a in _arrays(
        4, [(B, ps, H, D), (P, ps, Hkv, D), (P, ps, Hkv, D)], "float32"))
    bt = torch.tensor([[3, 4, 0, 0]], dtype=torch.int32)
    start = torch.tensor([ps], dtype=torch.int32)
    o1 = tref.chunked_prefill_attention(q, kp, vp, bt, start, D ** -0.5)
    kp[0], vp[0] = 1e4, -1e4                  # poison the scratch page
    o2 = tref.chunked_prefill_attention(q, kp, vp, bt, start, D ** -0.5)
    assert torch.equal(o1, o2)


def test_wrappers_refuse_unsupported_devices():
    # neither CUDA nor a plain version's device (CPU, meta)
    q = other_device((1, 4, 8))
    kp = other_device((2, 16, 2, 8))
    bt = other_device((1, 1), torch.int32)
    lens = other_device((1,), torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        paged_decode_attention(q, kp, kp, bt, lens)
    with pytest.raises(ValueError, match="no kernel"):
        chunked_prefill_attention(other_device((1, 1, 4, 8)), kp, kp, bt,
                                  lens)
