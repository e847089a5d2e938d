"""The port's recurrentgemma family (``models/rglru.py`` and windowed
attention, through ``Model``) against the reference's on bridged weights,
at ``recurrentgemma-9b`` ``.reduced()`` (3 layers: rglru, rglru, attn;
d_model 256, lru_width 256 in 4 gate blocks, 4 heads of 32 on one kv
head, window 64) and at a 5-layer variant whose last two RG-LRU layers
sit outside the pattern cycles (the reference's ``tail_0``/``tail_1``).

* ``rglru_apply`` alone, block-diagonal and dense gates: ``full`` mode
  with and without a cache (the conv tail zero-padded for prompts shorter
  than ``conv_width - 1``) and ``decode`` mode.
* ``Model.forward``: prefill into a dense cache of ``max_len`` 128 (the
  attention layers' ring is then min(64, 128) = 64 slots), then decode
  steps: logits and every cache leaf after prefill and after each step.
  Prompts of 2, 37, 64, 70 and 128 tokens: at 70 the reference's ring
  holds tokens 6..69 in slots 0..63 and its first decode overwrites slot
  70 % 64 = 6, which holds token 12, not the oldest token 6, so its decode
  attends another set of 64 tokens than a windowed recompute does
  (ROADMAP R6). The port reproduces that.
* Per-row decode of the stacked batcher's layout (one dispatch, (B,)
  positions) against the reference run row by row.
* The port's own init: the reference's tables, and ``lambda_init``'s
  distribution (a = exp(-8 softplus(Lambda)) ~ U[0.9, 0.999]).

Tolerances (fp32 weights, bf16 K/V and conv tail, fp32 state, as the
serving paths use them):
- full-prompt logits and block outputs: 1e-4 — fp32 on both sides,
  summed in other orders (measured <= 4e-6);
- the state ``h`` after prefill: 1e-4 — the scan in another order
  (associative against sequential), measured <= 1e-6;
- bf16 cache leaves (conv tail, K, V): one bf16 ulp (rtol 2^-7) plus
  1e-5 — their fp32 values come from matmuls summed in other orders
  (measured <= 4e-6 apart), so a value within that of a bf16 rounding
  boundary lands one ulp apart, and a value near zero may differ by more
  than one relative ulp;
- decode logits, which read those leaves: 1e-3, and the caches after
  decode steps: one bf16 ulp plus 1e-3, as tests/test_torch_ssm_model.py
  holds mamba2's (measured logits <= 5e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import rglru as jrglru
from repro.models.layers import init_params as jinit_params
from repro.models.model import get_model as jget_model
from repro.models.steps import make_serve_step as j_serve_step
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import rglru as trglru
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.steps import make_prefill_step, make_serve_step

FULL_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
DECODED_CACHE_TOL = dict(rtol=2 ** -7, atol=1e-3)
MAX_LEN = 128


def _configs(num_layers=None):
    jcfg = jget_config("recurrentgemma-9b").reduced()
    tcfg = tget_config("recurrentgemma-9b").reduced()
    if num_layers:
        jcfg = dataclasses.replace(jcfg, num_layers=num_layers)
        tcfg = dataclasses.replace(tcfg, num_layers=num_layers)
    return jcfg, tcfg


def _build(num_layers=None, seed=3):
    jcfg, tcfg = _configs(num_layers)
    jmodel, tmodel = jget_model(jcfg), tget_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed), "float32")
    tparams = bridge.from_reference(tcfg, jax.device_get(jparams))
    serve = jax.jit(j_serve_step(jmodel))
    return jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve


@pytest.fixture(scope="module")
def arch():
    return _build()


@pytest.fixture(scope="module")
def arch5():
    return _build(num_layers=5)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _assert_caches(tcfg, tcache, jcache, bf16_tol, h_tol):
    want = bridge.dense_cache_from_reference(tcfg, jax.device_get(jcache))
    assert len(want) == len(tcache) == tcfg.num_layers
    for got_l, want_l in zip(tcache, want):
        assert sorted(got_l) == sorted(want_l)
        for name, g in got_l.items():
            w = want_l[name]
            assert g.dtype == w.dtype and g.shape == w.shape, name
            tol = h_tol if name == "h" else bf16_tol
            np.testing.assert_allclose(_np(g), _np(w), **tol)


# ------------------------------------------------------------ the block

def _dense_gate_block(seed):
    """One RG-LRU block with dense (r, r) gates, drawn by the reference."""
    jcfg = dataclasses.replace(_configs()[0], lru_diag_blocks=0)
    tcfg = dataclasses.replace(_configs()[1], lru_diag_blocks=0)
    jp = jinit_params(jrglru.rglru_table(jcfg), jax.random.PRNGKey(seed),
                      jnp.float32)
    return jcfg, tcfg, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("gates", ["block_diagonal", "dense"])
@pytest.mark.parametrize("S", [2, 37])
def test_rglru_block_matches_reference(arch, gates, S):
    """``full`` without a cache, ``full`` into a cache (with a nonzero
    state that seeds the scan), then two ``decode`` steps: outputs and
    both cache leaves."""
    if gates == "dense":
        jcfg, tcfg, jp = _dense_gate_block(S)
        assert jp["w_rg"].ndim == 2
    else:
        jcfg, tcfg = arch[:2]
        jp = jax.tree.map(lambda a: np.array(a[0]), jax.device_get(
            arch[4]["blocks"]["slot0"]["mixer"]))
        assert jp["w_rg"].ndim == 3
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    rng = np.random.default_rng(S)
    B, r, W = 2, tcfg.lru_width, tcfg.conv_width
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    jo, none = jrglru.rglru_apply(jcfg, jp, jnp.asarray(x), None,
                                  mode="full")
    to, tnone = trglru.rglru_apply(tcfg, tp, torch.from_numpy(x), None,
                                   mode="full")
    assert none is None and tnone is None
    np.testing.assert_allclose(_np(to), _np(jo), **FULL_TOL)
    h0 = rng.standard_normal((B, r)).astype(np.float32)
    jc = {"conv": jnp.zeros((B, W - 1, r), jnp.bfloat16),
          "h": jnp.asarray(h0)}
    tc = {"conv": torch.zeros(B, W - 1, r, dtype=torch.bfloat16),
          "h": torch.from_numpy(h0.copy())}
    jo, jc = jrglru.rglru_apply(jcfg, jp, jnp.asarray(x), None, mode="full",
                                cache=jc)
    to, tc = trglru.rglru_apply(tcfg, tp, torch.from_numpy(x), None,
                                mode="full", cache=tc)
    np.testing.assert_allclose(_np(to), _np(jo), **FULL_TOL)
    np.testing.assert_allclose(_np(tc["conv"]), _np(jc["conv"]), **BF16_TOL)
    np.testing.assert_allclose(_np(tc["h"]), _np(jc["h"]), **STATE_TOL)
    if S < W - 1:                          # zero-padded in front
        assert not tc["conv"][:, :W - 1 - S].any()
    for _ in range(2):
        x1 = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        jo, jc = jrglru.rglru_apply(jcfg, jp, jnp.asarray(x1), None,
                                    mode="decode", cache=jc)
        to, tc = trglru.rglru_apply(tcfg, tp, torch.from_numpy(x1), None,
                                    mode="decode", cache=tc)
        np.testing.assert_allclose(_np(to), _np(jo), **DECODE_TOL)
        np.testing.assert_allclose(_np(tc["conv"]), _np(jc["conv"]),
                                   **DECODED_CACHE_TOL)
        np.testing.assert_allclose(_np(tc["h"]), _np(jc["h"]),
                                   **DECODED_CACHE_TOL)


# ------------------------------------------------------------ the model

def _prefill_then_decode(built, S, B=1, steps=3):
    jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve = built
    rng = np.random.default_rng(S + B)
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    jcache = jmodel.init_cache(B, MAX_LEN, dtype=jnp.bfloat16)
    jlogits, jcache, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                                        mode="full", cache=jcache)
    tcache = tmodel.init_cache(B, MAX_LEN, device="cpu")
    tlogits, tcache = tmodel.forward(tparams, tokens=torch.from_numpy(toks),
                                     mode="full", cache=tcache)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **FULL_TOL)
    _assert_caches(tcfg, tcache, jcache, BF16_TOL, STATE_TOL)
    tserve = make_serve_step(tmodel)
    logits = []
    for step in range(steps):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = serve(jparams, jcache, jnp.asarray(tok),
                           jnp.int32(S + step))
        tl, tcache = tserve(tparams, tcache, torch.from_numpy(tok), S + step)
        np.testing.assert_allclose(_np(tl), _np(jl), **DECODE_TOL)
        _assert_caches(tcfg, tcache, jcache, DECODED_CACHE_TOL,
                       DECODED_CACHE_TOL)
        logits.append((toks, tok, tl))
        toks = np.concatenate([toks, tok], axis=1)
    return tcache, logits


@pytest.mark.parametrize("S,B", [(2, 2), (37, 1), (64, 1), (70, 1),
                                 (128, 1)])
def test_prefill_then_decode_matches_reference(arch, S, B):
    tcache, _ = _prefill_then_decode(arch, S, B)
    W = min(arch[1].attn_window, MAX_LEN)
    assert [tuple(c["k"].shape) for c in tcache if "k" in c] == \
        [(B, W, 1, 32)]
    assert [sorted(c) for c in tcache] == [["conv", "h"]] * 2 + [["k", "v"]]


@pytest.mark.parametrize("S", [5, 70])
def test_tail_layers_match_reference(arch5, S):
    """Two RG-LRU layers past the one pattern cycle: the bridge maps the
    reference's ``tail_0``/``tail_1`` onto layers 3 and 4."""
    assert arch5[3].block_types == ["rglru", "rglru", "attn", "rglru",
                                    "rglru"]
    _prefill_then_decode(arch5, S, steps=2)


@pytest.mark.parametrize("S,bitten", [(64, False), (70, True), (128, False)])
def test_ring_layout_after_a_long_prompt_is_the_reference_s(arch, S, bitten):
    """ROADMAP R6. After a prompt of S > W = 64 tokens the ring holds the
    last 64 in order; the first decode writes slot S % 64. Where that is
    not 0 (S = 70) the overwritten token is not the oldest, so the decode
    attends another 64 tokens than a windowed recompute of the whole
    sequence does, in the reference and in the port alike. At S = 64 and
    128 the two agree. fp32 caches on both sides, so that the gap is the
    ring's and not the bf16 roundings'."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve = arch
    rng = np.random.default_rng(S)
    toks = rng.integers(1, jcfg.vocab_size, (1, S + 1)).astype(np.int32)
    jc = jmodel.init_cache(1, MAX_LEN, dtype=jnp.float32)
    _, jc, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks[:, :S]),
                              mode="full", cache=jc)
    jl, _ = serve(jparams, jc, jnp.asarray(toks[:, S:]), jnp.int32(S))
    tc = tmodel.init_cache(1, MAX_LEN, dtype=torch.float32, device="cpu")
    _, tc = tmodel.forward(tparams, tokens=torch.from_numpy(toks[:, :S]),
                           mode="full", cache=tc)
    tl, _ = make_serve_step(tmodel)(tparams, tc,
                                    torch.from_numpy(toks[:, S:]), S)
    full, _ = tmodel.forward(tparams, mode="full",
                             tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), **FULL_TOL)
    gap = float((full[:, -1] - tl).abs().max())
    jgap = float(np.abs(_np(full[:, -1]) - _np(jl)).max())
    if bitten:
        assert gap > 1e-2 and jgap > 1e-2, (gap, jgap)
    else:
        assert gap < 1e-4 and jgap < 1e-4, (gap, jgap)


def test_per_row_decode_matches_row_by_row_reference(arch):
    """The stacked batcher decodes every slot in one dispatch with (B,)
    positions; the reference vmaps a one-row step over slots. Rows
    prefilled with 5, 70 (a wrapped ring) and 1 tokens (an idle slot's
    dummy row) against the reference run row by row."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve = arch
    rng = np.random.default_rng(11)
    lens = (5, 70, 1)
    tcache = tmodel.init_cache(3, MAX_LEN, device="cpu")
    jcaches = []
    for b, n in enumerate(lens):
        toks = rng.integers(1, jcfg.vocab_size, (1, n)).astype(np.int32)
        jc = jmodel.init_cache(1, MAX_LEN, dtype=jnp.bfloat16)
        _, jc, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                                  mode="full", cache=jc)
        jcaches.append(jc)
        one = bridge.dense_cache_from_reference(tcfg, jax.device_get(jc))
        for layer, o in zip(tcache, one):
            for name, t in layer.items():
                t[b] = o[name][0]
    pos = np.array([5, 70, 0], np.int32)
    tok = rng.integers(1, jcfg.vocab_size, (3, 1)).astype(np.int32)
    tl, tcache = make_serve_step(tmodel)(tparams, tcache,
                                         torch.from_numpy(tok),
                                         torch.from_numpy(pos))
    for b in range(3):
        jl, jc = serve(jparams, jcaches[b], jnp.asarray(tok[b:b + 1]),
                       jnp.int32(pos[b]))
        np.testing.assert_allclose(_np(tl[b:b + 1]), _np(jl), **DECODE_TOL)
        _assert_caches(tcfg, [{n: t[b:b + 1] for n, t in layer.items()}
                              for layer in tcache], jc,
                       DECODED_CACHE_TOL, DECODED_CACHE_TOL)


def test_prefill_step_and_no_cache_mode(arch):
    """``make_prefill_step`` gives the last position's logits; a forward
    without a cache computes the same logits and returns no cache."""
    tmodel, tparams = arch[3], arch[5]
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        1, arch[0].vocab_size, (1, 90)).astype(np.int32))
    cache = tmodel.init_cache(1, MAX_LEN, device="cpu")
    last, cache = make_prefill_step(tmodel)(tparams, cache, toks)
    full, none = tmodel.forward(tparams, tokens=toks, mode="full")
    assert none is None
    assert torch.equal(last, full[:, -1])


# ------------------------------------------------------------- the init

def test_port_init_follows_reference_tables(arch5):
    """The same tree, shapes and dtypes as the reference's init (head
    layers none, one stacked cycle, two tail layers), and the reference's
    rules: zero norms, conv weights at scale 0.5, block gates at
    bs^-1/2."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve = arch5
    ref = jax.tree.map(np.asarray, jparams)
    p = tmodel.init(seed=3, device="cpu")
    back = bridge.to_reference(tcfg, p, ref)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
    bs = tcfg.lru_width // tcfg.lru_diag_blocks
    for layer, bt in zip(p["layers"], tmodel.block_types):
        m = layer["mixer"]
        assert not m["ln"].any() and not layer["mlp"]["ln"].any()
        if bt == "rglru":
            assert abs(float(m["conv"].std()) - 0.5) < 0.05
            assert abs(float(m["w_rg"].std()) - bs ** -0.5) < 0.01
    round_trip = bridge.from_reference(tcfg, back)
    for a, b in zip(p["layers"], round_trip["layers"]):
        for k in a["mixer"]:
            assert torch.equal(a["mixer"][k], b["mixer"][k])


def test_filled_cache_round_trips_bit_exactly(arch5):
    """A prefilled cache (wrapped ring, bf16 conv tails and K/V, fp32
    states, tail layers) goes to the reference's layout and back bit for
    bit."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve = arch5
    toks = np.random.default_rng(2).integers(1, jcfg.vocab_size,
                                             (2, 90)).astype(np.int32)
    jc = jmodel.init_cache(2, MAX_LEN, dtype=jnp.bfloat16)
    _, jc, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks), mode="full",
                              cache=jc)
    like = jax.device_get(jc)
    port = bridge.dense_cache_from_reference(tcfg, like)
    back = bridge.dense_cache_to_reference(tcfg, port, like)
    assert jax.tree.structure(back) == jax.tree.structure(like)
    for a, b in zip(jax.tree.leaves(like), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(np.asarray(a).view(np.uint8),
                              np.asarray(b).view(np.uint8))


def test_lambda_init_gives_the_reference_s_decays(arch):
    """a = exp(-8 softplus(Lambda)) is U[0.9, 0.999] on both sides: the
    bounds, and the mean and quartiles within four standard errors of a
    uniform of width 0.099 over 2 x 256 draws (mean 0.099 / sqrt(12 n) =
    1.3e-3; a quartile 0.099 sqrt(p (1-p) / n) <= 2.2e-3; the port
    against the reference sqrt(2) times that)."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve = arch

    def decays(lams):
        return np.concatenate([np.exp(-8.0 * np.logaddexp(0.0, lam))
                               for lam in lams])

    p = tmodel.init(seed=5, device="cpu")
    tl = [layer["mixer"]["lam"].numpy() for layer, bt in
          zip(p["layers"], tmodel.block_types) if bt == "rglru"]
    jl = list(np.asarray(jparams["blocks"]["slot0"]["mixer"]["lam"])) + \
        list(np.asarray(jparams["blocks"]["slot1"]["mixer"]["lam"]))
    ta, ja = decays(tl), decays(jl)
    for a in (ta, ja):
        assert a.min() >= 0.9 - 1e-6 and a.max() <= 0.999 + 1e-6
    for q in (0.25, 0.5, 0.75):
        assert abs(np.quantile(ta, q) - (0.9 + 0.099 * q)) < 9e-3
        assert abs(np.quantile(ta, q) - np.quantile(ja, q)) < 1.3e-2
    assert abs(ta.mean() - 0.9495) < 5.2e-3
    assert abs(ta.mean() - ja.mean()) < 7.4e-3
