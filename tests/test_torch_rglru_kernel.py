"""The plain version of the RG-LRU scan (``rglru_scan``, K6) and the
windowed plain ``flash_attention`` (K4 with a local-attention window)
against the reference.

* K6: against the reference's oracle ``repro.kernels.ref.rglru_scan`` at
  the three shapes of ``tests/test_kernels.py``'s sweep, with and without
  h0; against the Pallas kernel in interpret mode; against the model's
  ``repro.models.rglru.lru_scan``, an associative scan; and through the
  port's ``lru_scan``, which is what the model calls. bf16 inputs widen to
  fp32 exactly, as the Pallas kernel widens them.
* Windowed K4: against the reference's ``attend_naive`` and
  ``attend_blocked`` with a window, at recurrentgemma-9b's heads (head_dim
  256, 16 query heads on one kv head) and at its ``.reduced()`` heads.

Inputs are drawn with numpy from a seed and handed to both frameworks.

Tolerances:
- K6 against the sequential oracle and the Pallas kernel: 1e-5 — the same
  order of steps, fp32 on both sides; XLA may contract a multiply and an
  add into one FMA where the port rounds twice (a few fp32 ulps of
  states of magnitude < 10);
- K6 against the associative scan: rtol 1e-5, atol 2e-5 — another
  summation order over up to 128 steps of a decaying recurrence
  (a < 1), whose rounding errors decay with it;
- windowed attention: 2e-5, as tests/test_torch_dense_kernels.py holds
  K4 (fp32 on both sides, another summation order).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru import rglru_scan as pallas_rglru_scan
from repro.models.attention import attend_blocked, attend_naive
from repro.models.rglru import lru_scan as jlru_scan
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.models.rglru import lru_scan as tlru_scan

SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
ASSOC_TOL = dict(rtol=1e-5, atol=2e-5)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)

# (B, S, C, block_seq, block_lanes): tests/test_kernels.py's sweep
SWEEP = [(2, 64, 128, 32, 64), (1, 128, 256, 32, 128), (3, 32, 512, 16, 256)]


def _scan_inputs(seed, B, S, C, with_h0):
    """a = sigmoid of normals (a decay in (0, 1), as the gates give it), b
    and h0 unit normals."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, C))))).astype(
        np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    h0 = rng.standard_normal((B, C)).astype(np.float32) if with_h0 else None
    return a, b, h0


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,C,bs,bl", SWEEP)
def test_plain_scan_matches_reference_oracle(B, S, C, bs, bl, with_h0):
    a, b, h0 = _scan_inputs(S + C, B, S, C, with_h0)
    want = np.asarray(jref.rglru_scan(_j(a), _j(b), _j(h0)))
    n0 = rglru_scan.launches
    got = rglru_scan(_t(a), _t(b), _t(h0))
    assert rglru_scan.launches == n0         # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (B, S, C)
    np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)


@pytest.mark.parametrize("B,S,C,bs,bl", SWEEP)
def test_plain_scan_matches_pallas_interpret(B, S, C, bs, bl):
    a, b, h0 = _scan_inputs(7 * S, B, S, C, True)
    want = np.asarray(pallas_rglru_scan(_j(a), _j(b), _j(h0), block_seq=bs,
                                        block_lanes=bl, interpret=True))
    np.testing.assert_allclose(tref.rglru_scan(_t(a), _t(b), _t(h0)).numpy(),
                               want, **SCAN_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,C", [(2, 64, 128), (1, 128, 256), (1, 7, 33)])
def test_port_lru_scan_matches_associative_scan(B, S, C, with_h0):
    """The model's scan: the reference folds h0 into b[:, 0] and takes an
    associative scan; the port runs K6 from h0 (ragged C included)."""
    a, b, h0 = _scan_inputs(3 * S + C, B, S, C, with_h0)
    want = np.asarray(jlru_scan(_j(a), _j(b), _j(h0)))
    np.testing.assert_allclose(tlru_scan(_t(a), _t(b), _t(h0)).numpy(), want,
                               **ASSOC_TOL)


def test_plain_scan_widens_bf16_inputs():
    """bf16 a and b widen to fp32 exactly: the same result as their fp32
    values, as the Pallas kernel computes it."""
    a, b, h0 = _scan_inputs(5, 2, 40, 96, True)
    a16, b16 = a.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    ta = torch.from_numpy(a16.view(np.int16)).view(torch.bfloat16)
    tb = torch.from_numpy(b16.view(np.int16)).view(torch.bfloat16)
    got = rglru_scan(ta, tb, _t(h0))
    assert torch.equal(got, tref.rglru_scan(ta.float(), tb.float(), _t(h0)))
    want = np.asarray(jref.rglru_scan(_j(a16.astype(np.float32)),
                                      _j(b16.astype(np.float32)), _j(h0)))
    np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)


@pytest.mark.parametrize("B,S,H,Hkv,D,window,blocked", [
    (1, 200, 16, 1, 256, 64, False),       # recurrentgemma-9b heads
    (1, 300, 16, 1, 256, 5, False),        # a window under a key tile
    (1, 1536, 16, 1, 256, 512, True),      # attend_blocked, as S > 1024
    (2, 150, 4, 1, 32, 64, False),         # .reduced() heads
    (1, 1024, 4, 1, 32, 64, True),
    (1, 50, 16, 1, 256, 2048, False),      # the model's window, unbitten
])
def test_plain_windowed_flash_matches_reference(B, S, H, Hkv, D, window,
                                               blocked):
    rng = np.random.default_rng(S + window)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    pos = jnp.arange(S)
    attend = attend_blocked if blocked else attend_naive
    want = np.asarray(attend(_j(q), _j(k), _j(v), pos, pos, D ** -0.5,
                             window=window))
    n0 = flash_attention.launches
    got = flash_attention(_t(q), _t(k), _t(v), window=window)
    assert flash_attention.launches == n0
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("S,window,passed", [
    (50, 50, None),          # the window spans the prompt: causal walk
    (50, 2048, None),        # recurrentgemma-9b's window at max_len <= 2048
    (50, 49, 49),            # the last row loses key 0: windowed walk
])
def test_unbitten_window_takes_the_causal_walk(monkeypatch, S, window,
                                               passed):
    """A window of at least Sq masks nothing the causal mask allows, so
    the wrapper drops it (on the card the causal instantiation runs); the
    output is the windowed plain version's, bit for bit."""
    rng = np.random.default_rng(S + window)
    q, k, v = (_t(rng.standard_normal((1, S, h, 32)).astype(np.float32))
               for h in (4, 1, 1))
    want = tref.flash_attention(q, k, v, 32 ** -0.5, True, window)
    seen = []
    plain = tref.flash_attention

    def spy(*args):
        seen.append(args[5])
        return plain(*args)

    monkeypatch.setattr(tref, "flash_attention", spy)
    got = flash_attention(q, k, v, window=window)
    assert seen == [passed]
    assert torch.equal(got, want)


def test_window_must_be_causal_and_positive():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, k, causal=False, window=4)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, k, window=0)
