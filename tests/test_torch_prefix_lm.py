"""The prefix-LM mask and the frontends' ``embeddings`` input of the port
against the reference: paligemma-3b (a 256-token prefix-LM over a vision
stub's embeddings) and musicgen-large (an audio stub's embeddings), at
``.reduced()`` widths, on bridged weights.

* ``ref.flash_attention(..., prefix_len)`` (the plain K4, which the CPU
  wrapper takes) against the reference's ``attend_naive`` and
  ``attend_blocked`` with the same ``prefix_len``: a prefix that ends
  inside a key tile, a prefix at least as long as the prompt (the whole
  prompt bidirectional), a prefix with a local window, GQA at
  paligemma's 8 query heads on one kv head, and prompts above 1024
  tokens, where ``attend_blocked`` needs a multiple of 512 (ROADMAP R4).
  Both sides are fp32 and differ only in summation order: held to 2e-5,
  the reference's own tolerance between its naive and blocked paths
  (tests/test_models.py::test_blocked_attention_matches_naive).
* The port's counterpart of tests/test_models.py::
  test_prefill_decode_matches_full for paligemma-3b and musicgen-large,
  with the reference test's inputs (its ``jax.random`` draws, handed to
  the port as numpy arrays): the port's prefill and decode logits agree
  with its own full forward at the reference test's 2e-4, and every
  logit of the port agrees with the reference's at the same 2e-4 (fp32
  weights and caches on both sides; only summation order differs).
* The four P12a configs build; so do deepseek-v2-lite-16b and
  kimi-k2-1t-a32b since P12b, and ``make_batcher(cache="auto")`` picks
  the reference's cache manager for them.

The module runs under ``_torch_parity.lean_cpu`` (one torch thread), so
that its fp32 attention at 2,048 tokens does not spin against the other
test workers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from repro.configs.base import get_config as jget_config
from repro.models.attention import attend_blocked, attend_naive
from repro.models.model import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.steps import make_prefill_step

pytestmark = pytest.mark.usefixtures("lean_cpu")

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)

# (S, H, Hkv, prefix_len, window): the cases K4's prefix walk must meet
PREFIX_CASES = {
    "inside_a_key_tile": (96, 4, 2, 33, None),
    "one_key": (40, 4, 2, 1, None),
    "whole_prompt": (48, 4, 2, 256, None),
    "equal_to_prompt": (64, 4, 4, 64, None),
    "with_window": (128, 4, 2, 20, 16),
    "window_inside_prefix": (96, 4, 2, 64, 8),
    "paligemma_heads": (80, 8, 1, 16, None),
    "blocked_1536": (1536, 2, 1, 256, None),
    "blocked_2048_window": (2048, 2, 2, 300, 512),
}


def _qkv(S, H, Hkv, D=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, S, H, D)).astype(np.float32)
    k = rng.standard_normal((1, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((1, S, Hkv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_plain_prefix_attention_matches_reference(case):
    S, H, Hkv, prefix, window = PREFIX_CASES[case]
    q, k, v = _qkv(S, H, Hkv, seed=S + prefix)
    scale = 32 ** -0.5
    pos = jnp.arange(S)
    got = tref.flash_attention(*map(torch.from_numpy, (q, k, v)), scale,
                               True, window, prefix)
    # the CPU wrapper takes the plain version, prefix included
    wrapped = flash_attention(*map(torch.from_numpy, (q, k, v)), scale,
                              window=window, prefix_len=prefix)
    assert torch.equal(wrapped, got)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_blocked = attend_blocked(jq, jk, jv, pos, pos, scale, window,
                                  prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_blocked),
                               **ATTN_TOL)
    if S <= 1024:
        want = attend_naive(jq, jk, jv, pos, pos, scale, window, prefix)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_prefix_zero_is_the_causal_function():
    """``prefix_len=0`` is today's causal (and windowed) function bit for
    bit; a prefix changes exactly the rows above it."""
    q, k, v = map(torch.from_numpy, _qkv(64, 4, 2, seed=7))
    for window in (None, 8):
        base = tref.flash_attention(q, k, v, 0.2, True, window)
        assert torch.equal(
            tref.flash_attention(q, k, v, 0.2, True, window, 0), base)
    base = tref.flash_attention(q, k, v, 0.2)
    pre = tref.flash_attention(q, k, v, 0.2, prefix_len=20)
    # queries 0..18 see more keys; from 19 on the prefix is causal anyway
    assert not torch.equal(pre[:, :19], base[:, :19])
    assert torch.equal(pre[:, 19:], base[:, 19:])
    with pytest.raises(ValueError, match="prefix_len"):
        flash_attention(q, k, v, prefix_len=-1)


def _reference_inputs(cfg):
    """tests/test_models.py::test_prefill_decode_matches_full's inputs."""
    B, S, T = 2, 16, 4
    total = S + T
    key = jax.random.PRNGKey(3)
    if cfg.frontend == "vision":
        P = cfg.num_prefix_tokens
        emb = jax.random.normal(key, (B, P, cfg.d_model))
        toks = jax.random.randint(key, (B, total - P), 0, cfg.vocab_size)
        kw_full = dict(embeddings=emb, tokens=toks)
        kw_pre = dict(embeddings=emb, tokens=toks[:, :S - P])
        dec = toks[:, S - P:]
    else:                                   # audio: embeddings alone
        emb = jax.random.normal(key, (B, total, cfg.d_model))
        kw_full = dict(embeddings=emb)
        kw_pre = dict(embeddings=emb[:, :S])
        dec = None   # decode continues from tokens; compare only prefill
    return B, S, T, kw_full, kw_pre, dec


def _to_torch(kw):
    out = {}
    for name, x in kw.items():
        a = np.asarray(x)
        out[name] = torch.from_numpy(a.astype(np.int64) if name == "tokens"
                                     else a.astype(np.float32))
    return out


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large"])
def test_prefill_decode_matches_full(arch):
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    jmodel, tmodel = jget_model(jcfg), tget_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), "float32")
    tparams = bridge.from_reference(tcfg, jax.device_get(jparams))
    B, S, T, kw_full, kw_pre, dec = _reference_inputs(jcfg)
    jfull, _, _ = jmodel.forward(jparams, mode="full", **kw_full)
    tfull, _ = tmodel.forward(tparams, mode="full", **_to_torch(kw_full))
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), **MODEL_TOL)
    jcache = jmodel.init_cache(B, S + T, dtype=jnp.float32)
    jpre, jcache, _ = jmodel.forward(jparams, mode="full", cache=jcache,
                                     **kw_pre)
    tcache = tmodel.init_cache(B, S + T, dtype=torch.float32, device="cpu")
    tpre, tcache = tmodel.forward(tparams, mode="full", cache=tcache,
                                  **_to_torch(kw_pre))
    np.testing.assert_allclose(tpre[:, -1].numpy(), tfull[:, S - 1].numpy(),
                               **MODEL_TOL)
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), **MODEL_TOL)
    if dec is None:
        return
    dec_t = torch.from_numpy(np.asarray(dec).astype(np.int64))
    for t in range(T):
        jd, jcache, _ = jmodel.forward(jparams, mode="decode",
                                       tokens=dec[:, t:t + 1], cache=jcache,
                                       pos=jnp.int32(S + t))
        td, tcache = tmodel.forward(tparams, mode="decode",
                                    tokens=dec_t[:, t:t + 1], cache=tcache,
                                    pos=S + t)
        np.testing.assert_allclose(td[:, 0].numpy(),
                                   tfull[:, S + t].numpy(), **MODEL_TOL)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **MODEL_TOL)


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large"])
def test_prefill_step_takes_embeddings(arch):
    """The serving prefill step passes a frontend's embeddings through,
    as the reference's takes them in its inputs dict: the last position's
    logits equal the forward's."""
    tcfg = tget_config(arch).reduced()
    model = tget_model(tcfg)
    params = model.init(seed=1, device="cpu")
    rng = np.random.default_rng(5)
    emb = torch.from_numpy(
        rng.standard_normal((1, 12, tcfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (1, 6)))
    kw = dict(embeddings=emb, tokens=toks) \
        if tcfg.frontend == "vision" else dict(embeddings=emb)
    want, _ = model.forward(params, mode="full", **kw)
    cache = model.init_cache(1, 32, dtype=torch.float32, device="cpu")
    got, cache = make_prefill_step(model)(params, cache, **kw)
    assert torch.equal(got, want[:, -1])
    assert want.shape[1] == 18 if tcfg.frontend == "vision" else 12


def test_embeddings_are_cast_to_the_table_dtype():
    tcfg = tget_config("musicgen-large").reduced()
    model = tget_model(tcfg)
    params = model.init(seed=2, device="cpu")
    emb = torch.randn(1, 5, tcfg.d_model, dtype=torch.float64)
    a, _ = model.forward(params, embeddings=emb)
    b, _ = model.forward(params, embeddings=emb.float())
    assert a.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large",
                                  "qwen3-4b", "glm4-9b"])
def test_p12a_configs_are_admitted(arch):
    for cfg in (tget_config(arch), tget_config(arch).reduced()):
        tget_model(cfg)


@pytest.mark.parametrize("arch,what", [("deepseek-v2-lite-16b", "MLA"),
                                       ("kimi-k2-1t-a32b", "MoE")])
def test_moe_and_mla_still_refused_naming_p12b(arch, what):
    """Since P12b the port refuses neither: both configs build at full
    config and at ``.reduced()``, and ``make_batcher(cache="auto")``
    picks the reference's cache manager: stacked for deepseek (MLA's
    latent cache is not paged), the fused chunked paged pool for kimi
    (MoE on GQA attention). The name is the test's since P12a."""
    from repro.serving.batcher import make_batcher as jmake_batcher
    from repro.serving.batcher import paged_supported as jpaged
    from repro_torch.serving.batcher import make_batcher
    for cfg in (tget_config(arch), tget_config(arch).reduced()):
        model = tget_model(cfg)
        assert ("mla" in model.block_types) == (what == "MLA")
        assert model.layer_table(cfg.num_layers - 1).keys() == {"mixer",
                                                                 "moe"}
    b = make_batcher(tget_config(arch).reduced(), cache="auto", num_slots=2,
                     max_len=64, device="cpu")
    paged = jpaged(jget_config(arch).reduced())
    assert paged == (what == "MoE")
    assert type(b).__name__ == ("PagedContinuousBatcher" if paged
                                else "ContinuousBatcher")
    jb = jmake_batcher(jget_config(arch).reduced(), cache="auto",
                       num_slots=2, max_len=64)
    assert type(jb).__name__ == type(b).__name__
