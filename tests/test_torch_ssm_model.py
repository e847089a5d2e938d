"""The port's Mamba-2 model (``models/ssm.py`` through ``Model``) against
the reference's on bridged weights, at ``mamba2-370m`` ``.reduced()`` (2
layers, d_model 256, 32 heads of head_dim 16, state 16, chunk 16).

* ``Model.forward(mode="full")`` with and without a cache (the prefill of
  the stacked batcher and the per-request server), then decode steps that
  update the ``{"conv", "h"}`` cache in place: logits and caches after
  prefill and after every step. Prompts of 2 tokens (shorter than
  ``conv_width - 1``, so the conv tail is zero-padded in front), 37
  (three chunks, padded), 48 and 300 tokens. The same token ids, drawn
  with numpy from a seed, go to both sides.
* One block on inputs whose pre-conv features are integers: the bf16
  conv tail is bit for bit the reference's after a prefill and after a
  decode step.
* Per-row decode of the stacked batcher's layout against the reference
  run row by row, and the port's own init against the reference's tables.

Tolerances (fp32 weights, a bf16 conv tail and an fp32 state, as the
serving paths use them):
- full-prompt logits: 1e-4 — fp32 on both sides, summed in other orders
  (measured <= 2e-6);
- the state ``h`` after prefill: rtol 1e-3, atol 1e-4 — the chunk
  cumsum in another order can move a decay factor by 2 * 15 * 2^-24 *
  |cum| <= 7e-4 at chunk 16 (measured <= 3e-6);
- the conv tail: one bf16 ulp (rtol 2^-7) — its fp32 features come from
  two matmuls summed in other orders, and a value within an fp32 rounding
  of a bf16 rounding boundary lands one bf16 ulp apart (a few elements in
  a thousand; the integer-feature test shows the bits are otherwise
  equal);
- decode logits, which read that tail: 1e-3, and the caches after decode
  steps: one bf16 ulp plus 1e-3 (measured logits <= 2e-4, state <= 8e-4
  after a one-ulp conv difference), as tests/test_torch_dense_model.py
  holds the attention caches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import ssm as jssm
from repro.models.model import get_model as jget_model
from repro.models.steps import make_serve_step as j_serve_step
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import ssm as tssm
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.steps import make_prefill_step, make_serve_step

FULL_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-3, atol=1e-4)
CONV_TOL = dict(rtol=2 ** -7, atol=0)
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
DECODED_CACHE_TOL = dict(rtol=2 ** -7, atol=1e-3)


@pytest.fixture(scope="module")
def arch():
    jcfg = jget_config("mamba2-370m").reduced()
    tcfg = tget_config("mamba2-370m").reduced()
    jmodel, tmodel = jget_model(jcfg), tget_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3), "float32")
    tparams = bridge.from_reference(tcfg, jax.device_get(jparams))
    serve = jax.jit(j_serve_step(jmodel))
    return jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _assert_caches(tcfg, tcache, jcache, conv_tol, h_tol):
    want = bridge.dense_cache_from_reference(tcfg, jax.device_get(jcache))
    assert len(want) == len(tcache) == tcfg.num_layers
    for got_l, want_l in zip(tcache, want):
        assert got_l["conv"].dtype == want_l["conv"].dtype == torch.bfloat16
        assert got_l["h"].dtype == want_l["h"].dtype == torch.float32
        np.testing.assert_allclose(_np(got_l["conv"]), _np(want_l["conv"]),
                                   **conv_tol)
        np.testing.assert_allclose(_np(got_l["h"]), _np(want_l["h"]),
                                   **h_tol)


@pytest.mark.parametrize("S,B", [(2, 1), (37, 2), (48, 1), (300, 1)])
def test_full_prefill_then_decode(arch, S, B):
    """Prefill B prompts of S tokens, then four decode steps at one scalar
    position (the per-request server's pattern): logits and both cache
    leaves agree after prefill and after every step."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve = arch
    rng = np.random.default_rng(S + B)
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    jcache = jmodel.init_cache(B, 64, dtype=jnp.bfloat16)
    jlogits, jcache, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                                        mode="full", cache=jcache)
    tcache = tmodel.init_cache(B, 64, device="cpu")
    tlogits, tcache = tmodel.forward(tparams, tokens=torch.from_numpy(toks),
                                     mode="full", cache=tcache)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **FULL_TOL)
    _assert_caches(tcfg, tcache, jcache, CONV_TOL, STATE_TOL)
    tserve = make_serve_step(tmodel)
    for step in range(4):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = serve(jparams, jcache, jnp.asarray(tok),
                           jnp.int32(S + step))
        tl, tcache = tserve(tparams, tcache, torch.from_numpy(tok), S + step)
        np.testing.assert_allclose(_np(tl), _np(jl), **DECODE_TOL)
        _assert_caches(tcfg, tcache, jcache, DECODED_CACHE_TOL,
                       DECODED_CACHE_TOL)


def test_prefill_step_and_no_cache_mode(arch):
    """``make_prefill_step`` gives the last position's logits; a forward
    without a cache computes the same logits and returns no cache."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve = arch
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        1, jcfg.vocab_size, (1, 50)).astype(np.int32))
    cache = tmodel.init_cache(1, 64, device="cpu")
    last, cache = make_prefill_step(tmodel)(tparams, cache, toks)
    full, none = tmodel.forward(tparams, tokens=toks, mode="full")
    assert none is None
    assert torch.equal(last, full[:, -1])


def _integer_block(arch, rng):
    """Layer 0's parameters with integer x/B/C projections, in both
    frameworks: +-1 in the first 63 input rows and 0 below. With a zero
    ``ln`` a +-1 input normalises to +-(1 - 5e-7), so every pre-conv
    feature is an odd integer of magnitude < 64 to within 1e-4, which both
    sides round to the same bf16 value whatever order their matmuls sum
    in (an exact 0 would not do: its fp32 residue keeps full relative
    precision in bf16)."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve = arch
    jp = jax.tree.map(lambda a: np.array(a[0]),
                      jax.device_get(jparams["blocks"]["slot0"]["mixer"]))
    for name in ("wx", "wB", "wC"):
        w = rng.choice([-1.0, 1.0], jp[name].shape).astype(np.float32)
        w[63:] = 0.0
        jp[name] = w
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("S", [2, 37])
def test_block_conv_tail_is_bit_exact(arch, S):
    jcfg, tcfg = arch[:2]
    rng = np.random.default_rng(S)
    jp, tp = _integer_block(arch, rng)
    B, W = 2, tcfg.conv_width
    C = tcfg.ssm_inner + 2 * tcfg.ssm_state
    x = rng.choice([-1.0, 1.0], (B, S, tcfg.d_model)).astype(np.float32)
    jcache = {"conv": jnp.zeros((B, W - 1, C), jnp.bfloat16),
              "h": jnp.zeros((B, tcfg.ssm_heads, tcfg.ssm_head_dim,
                              tcfg.ssm_state), jnp.float32)}
    tcache = {"conv": torch.zeros(B, W - 1, C, dtype=torch.bfloat16),
              "h": torch.zeros(jcache["h"].shape)}
    _, jcache = jssm.ssm_apply(jcfg, jp, jnp.asarray(x), None, mode="full",
                               cache=jcache)
    _, tcache = tssm.ssm_apply(tcfg, tp, torch.from_numpy(x), None,
                               mode="full", cache=tcache)

    def bits(c):
        return bridge.to_numpy(c["conv"], np.asarray(jcache["conv"]))

    assert np.array_equal(bits(tcache).view(np.uint16),
                          np.asarray(jcache["conv"]).view(np.uint16))
    if S < W - 1:                          # zero-padded in front
        assert not tcache["conv"][:, :W - 1 - S].any()
    x1 = rng.choice([-1.0, 1.0], (B, 1, tcfg.d_model)).astype(np.float32)
    _, jcache = jssm.ssm_apply(jcfg, jp, jnp.asarray(x1), None,
                               mode="decode", cache=jcache)
    _, tcache = tssm.ssm_apply(tcfg, tp, torch.from_numpy(x1), None,
                               mode="decode", cache=tcache)
    assert np.array_equal(bits(tcache).view(np.uint16),
                          np.asarray(jcache["conv"]).view(np.uint16))


def test_per_row_decode_matches_row_by_row_reference(arch):
    """The stacked batcher decodes every slot in one dispatch; the
    reference vmaps a one-row step over slots. Rows prefilled with 5, 40
    and 1 tokens (an idle slot's dummy row) against the reference run row
    by row: logits, and each row's caches."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve = arch
    rng = np.random.default_rng(11)
    lens = (5, 40, 1)
    tcache = tmodel.init_cache(3, 48, device="cpu")
    jcaches = []
    for b, n in enumerate(lens):
        toks = rng.integers(1, jcfg.vocab_size, (1, n)).astype(np.int32)
        jc = jmodel.init_cache(1, 48, dtype=jnp.bfloat16)
        _, jc, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                                  mode="full", cache=jc)
        jcaches.append(jc)
        one = bridge.dense_cache_from_reference(tcfg, jax.device_get(jc))
        for layer, o in zip(tcache, one):
            for name in ("conv", "h"):
                layer[name][b] = o[name][0]
    pos = np.array([5, 40, 0], np.int32)
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


def test_port_init_follows_reference_tables(arch):
    """The same tree, shapes and dtypes as the reference's init, and the
    reference's rules: A_log = log(1..H), D = 1, dt_bias the softplus
    inverse of U[1e-3, 1e-1], zero norms, conv weights at scale 0.5."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve = arch
    ref = jax.tree.map(np.asarray, jparams)
    p = tmodel.init(seed=3, device="cpu")
    back = bridge.to_reference(tcfg, p, ref)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
    H = tcfg.ssm_heads
    for layer in p["layers"]:
        m = layer["mixer"]
        assert set(layer) == {"mixer"}              # d_ff = 0: no MLP
        assert torch.equal(m["A_log"], torch.log(torch.arange(1., H + 1)))
        assert m["A_log"].dtype == torch.float32
        assert torch.equal(m["D"], torch.ones(H))
        dt = torch.nn.functional.softplus(m["dt_bias"])
        assert (dt >= 1e-3 - 1e-6).all() and (dt <= 1e-1 + 1e-6).all()
        assert not m["ln"].any() and not m["gn"].any()
        assert abs(float(m["conv_x"].std()) - 0.5) < 0.05
    np.testing.assert_allclose(       # log rounds alike to an fp32 ulp
        ref["blocks"]["slot0"]["mixer"]["A_log"][0],
        p["layers"][0]["mixer"]["A_log"].numpy(), rtol=2e-7, atol=0)


@pytest.mark.parametrize("arch_id,names", [
    ("kimi-k2-1t-a32b", "MoE"),
    ("deepseek-v2-lite-16b", "MLA"),
    ("qwen3-32b", None),
])
def test_model_admits_attn_and_ssm_patterns_only(arch_id, names):
    """Every case builds: attention-only configs since the first slice,
    MoE (kimi) and MLA (deepseek) since P12b, whose layers after the
    dense first one carry the MoE block. The name is the test's since
    PR 13."""
    cfg = tget_config(arch_id).reduced()
    model = tget_model(cfg)
    params = model.init(seed=0, device="cpu")
    if names is None:                              # attention-only
        assert all("mlp" in layer for layer in params["layers"])
        return
    assert "moe" in params["layers"][-1]
    assert ("mla" in model.block_types) == (names == "MLA")


def test_hybrid_pattern_dispatches_each_layer():
    """A pattern mixing both admitted mixers builds one attention cache
    and one SSM cache per cycle, with an MLP after each."""
    cfg = dataclasses.replace(tget_config("mamba2-370m").reduced(),
                              pattern=("attn", "ssm"), num_layers=4,
                              num_heads=4, num_kv_heads=2, head_dim=32,
                              d_ff=128)
    model = tget_model(cfg)
    assert model.block_types == ["attn", "ssm", "attn", "ssm"]
    cache = model.init_cache(2, 32, device="cpu")
    assert [sorted(c) for c in cache] == [["k", "v"], ["conv", "h"]] * 2
    params = model.init(seed=0, device="cpu")
    assert all("mlp" in layer for layer in params["layers"])
    toks = torch.randint(1, cfg.vocab_size, (2, 20))
    logits, cache = model.forward(params, tokens=toks, mode="full",
                                  cache=cache)
    assert logits.shape == (2, 20, cfg.vocab_size)
    logits, _ = model.forward(params, tokens=toks[:, :1], mode="decode",
                              cache=cache, pos=20)
    assert torch.isfinite(logits).all()
