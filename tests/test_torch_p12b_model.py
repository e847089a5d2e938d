"""deepseek-v2-lite-16b (MLA and MoE) and kimi-k2-1t-a32b (MoE on GQA
attention) through the port's ``Model`` against the reference's, at
``.reduced()`` widths on the reference's seeded weights.

* Both configs build in the port, at full config and at ``.reduced()``:
  layer 0 takes the dense MLP (``first_dense_layers``), the rest the MoE
  block; deepseek's mixers are MLA.
* The bridge carries the reference's stacked ``moe`` leaves ((G, E, d,
  f)), its MLA leaves and ``head_0`` both ways, bit for bit (fp32 and
  bf16), and a filled ``ckr`` dense cache both ways.
* Full-mode logits to 2e-5 and the summed MoE aux loss to 1e-6 relative
  against the reference's ``Model.forward`` (both fp32; summation order
  only, measured <= 6e-6); the port's ``forward`` keeps returning
  (logits, cache) unless asked for the aux.
* tests/test_models.py::test_prefill_decode_matches_full on the port, at
  its 2e-4: the last prefill row and four decode rows (an fp32 cache)
  against the full forward's, and each against the reference's at 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models.model import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models.model import get_model as tget_model

ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]
TOL = dict(rtol=2e-5, atol=2e-5)


def _ref(arch, dtype="float32", seed=0):
    jcfg = jget_config(arch).reduced()
    tcfg = tget_config(arch).reduced()
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed), dtype)
    return jcfg, tcfg, jmodel, jparams, jax.tree.map(np.asarray, jparams)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_build_with_dense_head_and_moe_layers(arch):
    for cfg in (tget_config(arch), tget_config(arch).reduced()):
        model = tget_model(cfg)
        want = "mla" if cfg.use_mla else "attn"
        assert model.block_types == [want] * cfg.num_layers
        for i in range(cfg.num_layers):
            t = model.layer_table(i)
            assert set(t) == ({"mixer", "mlp"} if i < cfg.first_dense_layers
                              else {"mixer", "moe"})
        moe = model.layer_table(cfg.num_layers - 1)["moe"]
        assert moe["we_gate"].shape == (cfg.num_experts, cfg.d_model,
                                        cfg.moe_d_ff)
        assert ("shared" in moe) == bool(cfg.num_shared_experts)
    params = tget_model(tget_config(arch).reduced()).init(seed=0,
                                                          device="cpu")
    assert "mlp" in params["layers"][0] and "moe" in params["layers"][1]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_exact(arch, dtype):
    _, tcfg, _, _, ref = _ref(arch, dtype, seed=1)
    port = bridge.from_reference(tcfg, ref)
    assert len(port["layers"]) == tcfg.num_layers
    want_dt = torch.float32 if dtype == "float32" else torch.bfloat16
    moe = port["layers"][1]["moe"]
    assert moe["we_down"].dtype == want_dt
    assert np.array_equal(
        _bits(bridge.to_numpy(moe["we_down"],
                              ref["blocks"]["slot0"]["moe"]["we_down"][0])),
        _bits(ref["blocks"]["slot0"]["moe"]["we_down"][0]))
    assert np.array_equal(
        _bits(bridge.to_numpy(port["layers"][0]["mlp"]["w_up"],
                              ref["head_0"]["mlp"]["w_up"])),
        _bits(ref["head_0"]["mlp"]["w_up"]))
    back = bridge.to_reference(tcfg, port, ref)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_follows_reference_tables(arch):
    """The port's own seeded init has the reference's leaves, shapes and
    dtypes in the reference's layout (its draws are its own)."""
    _, tcfg, _, _, ref = _ref(arch)
    own = tget_model(tcfg).init(seed=3, device="cpu")
    back = bridge.to_reference(tcfg, own, ref)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    router = own["layers"][1]["moe"]["router"]
    assert abs(float(router.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.1


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_cache_round_trip_is_bit_exact(arch, dtype):
    """A filled reference dense cache (deepseek: ``ckr``; kimi: ``k``/
    ``v``) crosses to the port's per-layer list and back bit for bit."""
    jcfg, tcfg, jmodel, jparams, _ = _ref(arch)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 9))
    cache = jmodel.init_cache(2, 16, dtype=getattr(jnp, dtype))
    _, cache, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                                 cache=cache)
    like = jax.tree.map(np.asarray, cache)
    port = bridge.dense_cache_from_reference(tcfg, like)
    names = {"ckr"} if tcfg.use_mla else {"k", "v"}
    assert [set(layer) for layer in port] == [names] * tcfg.num_layers
    assert port[0][sorted(names)[0]].float().abs().sum() > 0
    back = bridge.dense_cache_to_reference(tcfg, port, like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(like)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_logits_and_aux_match_reference(arch):
    jcfg, tcfg, jmodel, jparams, ref = _ref(arch)
    params = bridge.from_reference(tcfg, ref)
    model = tget_model(tcfg)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                             (3, 24)).astype(np.int32)
    jl, _, jaux = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    tl, cache, aux = model.forward(params, tokens=torch.from_numpy(toks),
                                   return_aux=True)
    assert cache is None and aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert float(aux) > 0
    out = model.forward(params, tokens=torch.from_numpy(toks))
    assert len(out) == 2 and torch.equal(out[0], tl)


def test_aux_is_zero_without_moe_layers():
    tcfg = tget_config("smollm-135m").reduced()
    model = tget_model(tcfg)
    params = model.init(seed=0, device="cpu")
    _, _, aux = model.forward(params, tokens=torch.ones(1, 4, dtype=torch.int64),
                              return_aux=True)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full(arch):
    """tests/test_models.py::test_prefill_decode_matches_full on the port:
    B 2, a 16-token prefill into an fp32 cache, 4 decode steps."""
    jcfg, tcfg, jmodel, jparams, ref = _ref(arch)
    params = bridge.from_reference(tcfg, ref)
    model = tget_model(tcfg)
    B, S, T = 2, 16, 4
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size,
                                             (B, S + T)).astype(np.int32)
    full, _ = model.forward(params, tokens=torch.from_numpy(toks))
    jfull, _, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), **TOL)
    cache = model.init_cache(B, S + T, dtype=torch.float32, device="cpu")
    lp, cache = model.forward(params, tokens=torch.from_numpy(toks[:, :S]),
                              cache=cache)
    np.testing.assert_allclose(lp[:, -1].numpy(), full[:, S - 1].numpy(),
                               rtol=2e-4, atol=2e-4)
    jcache = jmodel.init_cache(B, S + T, dtype=jnp.float32)
    _, jcache, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks[:, :S]),
                                  cache=jcache)
    for t in range(T):
        tok = toks[:, S + t:S + t + 1]
        ld, cache = model.forward(params, tokens=torch.from_numpy(tok),
                                  mode="decode", cache=cache, pos=S + t)
        np.testing.assert_allclose(ld[:, 0].numpy(), full[:, S + t].numpy(),
                                   rtol=2e-4, atol=2e-4)
        jld, jcache, _ = jmodel.forward(jparams, tokens=jnp.asarray(tok),
                                        mode="decode", cache=jcache,
                                        pos=jnp.int32(S + t))
        np.testing.assert_allclose(ld.numpy(), np.asarray(jld), **TOL)
    port_cache = bridge.dense_cache_from_reference(
        tcfg, jax.tree.map(np.asarray, jcache))
    for a, b in zip(cache, port_cache):
        for name in a:
            np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                       **TOL)


def test_vector_pos_decode_through_the_model():
    """deepseek's model decodes rows at different positions in one call
    (the stacked batcher's decode) as it decodes each row alone: logits
    to 1e-5 and the bf16 latents to one ulp (batched and one-row
    matmuls may block their sums differently; measured bit-equal)."""
    _, tcfg, _, _, ref = _ref("deepseek-v2-lite-16b")
    params = bridge.from_reference(tcfg, ref)
    model = tget_model(tcfg)
    rng = np.random.default_rng(6)
    lens = [5, 9, 13]
    caches, rows = [], []
    for n in lens:
        c = model.init_cache(1, 24, device="cpu")
        ids = torch.from_numpy(rng.integers(1, tcfg.vocab_size, (1, n)))
        model.forward(params, tokens=ids, cache=c)
        caches.append(c)
    stacked = [{k: torch.cat([c[i][k] for c in caches]) for k in caches[0][i]}
               for i in range(tcfg.num_layers)]
    tok = torch.from_numpy(rng.integers(1, tcfg.vocab_size, (3, 1)))
    lg, stacked = model.forward(params, tokens=tok, mode="decode",
                                cache=stacked,
                                pos=torch.tensor(lens, dtype=torch.int32))
    for b, (n, c) in enumerate(zip(lens, caches)):
        lb, c = model.forward(params, tokens=tok[b:b + 1], mode="decode",
                              cache=c, pos=n)
        np.testing.assert_allclose(lg[b].numpy(), lb[0].numpy(), rtol=1e-5,
                                   atol=1e-5)
        for i in range(tcfg.num_layers):      # one bf16 ulp at most
            np.testing.assert_allclose(stacked[i]["ckr"][b].float().numpy(),
                                       c[i]["ckr"][0].float().numpy(),
                                       rtol=2.0 ** -7, atol=1e-4)
