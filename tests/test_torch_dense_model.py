"""The port's dense-cache model paths against the reference's on bridged
weights: ``Model.forward(mode="full")`` into a dense cache (the prefill of
the stacked batcher, the per-request server and ``prefill="full"``), then
dense decode steps, for smollm-135m and qwen3-4b (``qk_norm``) reduced.

Prompts stay at <= 1024 tokens, where the reference attends with
``attend_naive``, plus one 1536-token prompt, which it attends with
``attend_blocked`` (ROADMAP R4: that path needs a multiple of 512 above
1024 tokens). The same token ids, drawn with numpy from a seed, go to both
sides.

Tolerances (fp32 weights, bf16 caches as the serving paths use them):
- full-prompt logits: 1e-4 — both sides attend the fresh fp32 K/V in
  fp32 and differ only in summation order over up to 1536 keys;
- written caches: one bf16 ulp (rtol 2^-7) plus 1e-4 — a K/V value a
  rounding apart in fp32 can land one bf16 ulp apart;
- decode logits, which read the bf16 cache: 1e-3, and the cache after
  decode steps: one bf16 ulp plus 1e-3, as tests/test_torch_bridge_model.py
  holds the paged decode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models.model import get_model as jget_model
from repro.models.steps import make_serve_step as j_serve_step
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.steps import make_prefill_step, make_serve_step

FULL_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=2 ** -7, atol=1e-4)
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
DECODED_CACHE_TOL = dict(rtol=2 ** -7, atol=1e-3)


@pytest.fixture(scope="module", params=["smollm-135m", "qwen3-4b"])
def arch(request):
    jcfg = jget_config(request.param).reduced()
    tcfg = tget_config(request.param).reduced()
    jmodel, tmodel = jget_model(jcfg), tget_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3), "float32")
    tparams = bridge.from_reference(tcfg, jax.device_get(jparams))
    serve = jax.jit(j_serve_step(jmodel))
    return jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve


def _logits_np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _assert_caches(tcfg, tcache, jcache, **tol):
    want = bridge.dense_cache_from_reference(tcfg, jax.device_get(jcache))
    for got_l, want_l in zip(tcache, want):
        for name in ("k", "v"):
            np.testing.assert_allclose(got_l[name].float().numpy(),
                                       want_l[name].float().numpy(), **tol)


@pytest.mark.parametrize("S,B,max_len", [(37, 1, 64), (300, 2, 320),
                                         (1024, 1, 1040), (1536, 1, 1552)])
def test_full_prefill_then_dense_decode(arch, S, B, max_len):
    """Prefill B prompts of S tokens into a (B, max_len) cache, then four
    decode steps at one scalar position (the per-request server's
    pattern): logits and the whole cache agree after every step."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve = arch
    rng = np.random.default_rng(S + B)
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    jcache = jmodel.init_cache(B, max_len, dtype=jnp.bfloat16)
    jlogits, jcache, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                                        mode="full", cache=jcache)
    tcache = tmodel.init_cache(B, max_len, device="cpu")
    tlogits, tcache = tmodel.forward(tparams, tokens=torch.from_numpy(toks),
                                     mode="full", cache=tcache)
    np.testing.assert_allclose(_logits_np(tlogits), _logits_np(jlogits),
                               **FULL_TOL)
    _assert_caches(tcfg, tcache, jcache, **CACHE_TOL)
    tserve = make_serve_step(tmodel)
    for step in range(4):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = serve(jparams, jcache, jnp.asarray(tok),
                           jnp.int32(S + step))
        tl, tcache = tserve(tparams, tcache, torch.from_numpy(tok), S + step)
        np.testing.assert_allclose(_logits_np(tl), _logits_np(jl),
                                   **DECODE_TOL)
    _assert_caches(tcfg, tcache, jcache, **DECODED_CACHE_TOL)


def test_prefill_step_returns_last_position_and_no_cache_mode(arch):
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


def test_per_row_positions_match_row_by_row_reference(arch):
    """The stacked batcher decodes every slot at its own position in one
    dispatch; the reference vmaps a scalar-position step over slots. Rows
    at positions 5, 40 and 0 (an idle slot's dummy token) against the
    reference run row by row."""
    jcfg, tcfg, jmodel, tmodel, jparams, tparams, serve = arch
    rng = np.random.default_rng(11)
    lens, max_len = (5, 40, 1), 48
    tcache = tmodel.init_cache(3, max_len, device="cpu")
    jcaches = []
    for b, n in enumerate(lens):
        toks = rng.integers(1, jcfg.vocab_size, (1, n)).astype(np.int32)
        jc = jmodel.init_cache(1, max_len, dtype=jnp.bfloat16)
        _, jc, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                                  mode="full", cache=jc)
        jcaches.append(jc)
        one = bridge.dense_cache_from_reference(tcfg, jax.device_get(jc))
        for layer, o in zip(tcache, one):
            for name in ("k", "v"):
                layer[name][b] = o[name][0]
    pos = np.array([5, 40, 0], np.int32)
    tok = rng.integers(1, jcfg.vocab_size, (3, 1)).astype(np.int32)
    tl, tcache = make_serve_step(tmodel)(tparams, tcache,
                                         torch.from_numpy(tok),
                                         torch.from_numpy(pos))
    for b in range(3):
        jl, jc = serve(jparams, jcaches[b], jnp.asarray(tok[b:b + 1]),
                       jnp.int32(pos[b]))
        np.testing.assert_allclose(_logits_np(tl[b:b + 1]), _logits_np(jl),
                                   **DECODE_TOL)
        _assert_caches(tcfg, [{n: t[b:b + 1] for n, t in layer.items()}
                              for layer in tcache], jc, **CACHE_TOL)
