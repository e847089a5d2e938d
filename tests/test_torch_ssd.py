"""The plain Mamba-2 SSD versions (``kernels/ref.py``: ``ssd_chunk``,
K5's plain version, and ``ssd_full``) and the port's ``ssd_chunked``
against the reference: ``repro.kernels.ref``, the Pallas ``ssd_chunk``
in interpret mode (one case) and ``repro.models.ssm.ssd_chunked``.

Inputs are drawn with numpy from a seed at Mamba-2's init and handed to
both frameworks: x, B and C are silu of unit normals, dt =
softplus(N(0,1) + dt_bias) with dt_bias = softplus^-1(U[1e-3, 1e-1]), a =
-(1..H); the strong cases make the last head decay at a = -32 with dt ~ 1.
The sweeps cover ragged chunk lengths, several chunks, and sequences that
``ssd_chunked`` pads to a whole chunk with dt = 0 steps.

Tolerances:
- chunk pieces: ``kernels.ssd.error_bound`` — 1e-4 of the sum of each
  output's term magnitudes (fp32 rounding of two products on both sides),
  widened by e^(2 dc) - 1 where the two sides' ``cum`` differ by dc (XLA
  and PyTorch may sum the prefix in other orders; at |cum| ~ 8,000 one
  ulp is 5e-4);
- ``ssd_full`` and ``ssd_chunked`` (y and the final state): rtol 1e-3 and
  atol 1e-4 — the chunk pieces' bound on outputs of unit scale, plus the
  inter-chunk recurrence summed in the same order on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import ssd as jssd
from repro.models import ssm as jssm
from _torch_parity import other_device
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd import error_bound, ssd_chunk
from repro_torch.models import ssm as tssm

SCAN_TOL = dict(rtol=1e-3, atol=1e-4)


def _silu(a):
    return a / (1.0 + np.exp(-a))


def _softplus(a):
    return np.logaddexp(a, 0.0)


def _draw(seed, lead, H, P, N, strong=False):
    """numpy inputs of shapes lead + (H, P), lead + (H,), (H,), lead +
    (N,), lead + (N,), all fp32."""
    rng = np.random.default_rng(seed)
    x = _silu(rng.standard_normal(lead + (H, P)))
    B_ = _silu(rng.standard_normal(lead + (N,)))
    C_ = _silu(rng.standard_normal(lead + (N,)))
    u = rng.uniform(1e-3, 1e-1, H)
    dt = _softplus(rng.standard_normal(lead + (H,)) + np.log(np.expm1(u)))
    a = -np.arange(1, H + 1, dtype=np.float64)
    if strong:
        a[-1] = -32.0
        dt[..., -1] = rng.uniform(0.9, 1.1, lead)
    return tuple(np.asarray(t, np.float32) for t in (x, dt, a, B_, C_))


def _t(arrs):
    return tuple(torch.from_numpy(a.copy()) for a in arrs)


def _assert_pieces(got, want, inputs):
    bounds, dc = error_bound(*inputs, got[3], want[3])
    for name, g, w, b in zip(("y_intra", "state", "decay", "cum"), got,
                             want, bounds):
        assert g.shape == w.shape, name
        excess = float(((g - w).abs() - b).max())
        assert excess <= 0, (name, excess, float(dc.max()))


@pytest.mark.parametrize("Bsz,nc,Q,H,P,N,strong", [
    (1, 1, 1, 2, 16, 16, False),
    (2, 3, 16, 4, 16, 16, False),        # mamba2 .reduced() chunks
    (1, 2, 37, 3, 8, 16, True),          # ragged Q, strong decay
    (1, 1, 256, 2, 16, 32, True),        # a full-width chunk, |cum| ~ 8e3
])
def test_plain_ssd_chunk_matches_reference(Bsz, nc, Q, H, P, N, strong):
    arrs = _draw(Q + nc, (Bsz, nc, Q), H, P, N, strong)
    want = [torch.from_numpy(np.array(w)) for w in
            jref.ssd_chunk(*map(jnp.asarray, arrs))]
    inputs = _t(arrs)
    got = tref.ssd_chunk(*inputs)
    _assert_pieces(got, want, inputs)


def test_plain_ssd_chunk_matches_pallas_interpret():
    """One case against the Pallas kernel itself, run in interpret mode."""
    arrs = _draw(5, (1, 2, 16), 2, 16, 16)
    want = [torch.from_numpy(np.array(w)) for w in
            jssd.ssd_chunk(*map(jnp.asarray, arrs), interpret=True)]
    inputs = _t(arrs)
    _assert_pieces(tref.ssd_chunk(*inputs), want, inputs)


def test_wrapper_takes_the_plain_version_on_cpu():
    inputs = _t(_draw(6, (1, 2, 16), 4, 16, 16))
    n0 = ssd_chunk.launches
    got = ssd_chunk(*inputs)
    assert ssd_chunk.launches == n0          # no kernel ran
    for g, w in zip(got, tref.ssd_chunk(*inputs)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="no kernel"):
        ssd_chunk(*(other_device(t.shape) for t in inputs))


@pytest.mark.parametrize("S,chunk", [(32, 16), (48, 16)])
def test_plain_ssd_full_matches_reference(S, chunk):
    arrs = _draw(S, (2, S), 4, 16, 16)
    want = np.asarray(jref.ssd_full(*map(jnp.asarray, arrs), chunk))
    got = tref.ssd_full(*_t(arrs), chunk)
    np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)


@pytest.mark.parametrize("S,chunk,strong", [
    (1, 16, False),            # one step: Q = 1
    (5, 16, False),            # shorter than a chunk: Q = S
    (16, 16, True),            # exactly one chunk
    (37, 16, True),            # three chunks, the last padded by 11 steps
    (300, 256, False),         # mamba2-370m's chunk, padded by 212 steps
])
def test_ssd_chunked_matches_reference(S, chunk, strong):
    """``(y, h_final)`` of the port's ``ssd_chunked`` (K5's pieces, the
    inter-chunk recurrence and the y_inter combine in PyTorch) against the
    reference's scan, with the dt = 0 padding of a ragged tail."""
    arrs = _draw(S + chunk, (2, S), 4, 16, 16, strong)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, arrs), chunk)
    ty, th = tssm.ssd_chunked(*_t(arrs), chunk)
    assert ty.shape == (2, S, 4, 16) and th.shape == (2, 4, 16, 16)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SCAN_TOL)


def test_padding_leaves_the_final_state_unchanged():
    """dt = 0 steps decay by exp(0) = 1 and add nothing: the final state
    of a padded sequence is the unpadded one's, bit for bit, and so are
    its y rows."""
    x, dt, a, B_, C_ = _t(_draw(9, (1, 32), 4, 16, 16, True))
    y, h = tssm.ssd_chunked(x, dt, a, B_, C_, 16)
    x2, dt2, B2, C2 = (torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2)
                                               + (0, 16))
                       for t in (x, dt, B_, C_))
    y2, h2 = tssm.ssd_chunked(x2, dt2, a, B2, C2, 16)
    assert torch.equal(h2, h)
    assert torch.equal(y2[:, :32], y)
