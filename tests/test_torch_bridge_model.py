"""The port's model against the reference's on bridged weights.

* The bridge round trip is bit-exact (fp32 and bf16), including the split
  of the reference's stacked layer dim into per-layer dicts, for
  attention layers and for mamba2's SSM layers, and so is the round trip
  of a filled mamba2 dense cache (bf16 ``conv``, fp32 ``h``).
* The port's own seeded init follows the reference's parameter tables.
* Logits of paged ``mode="chunk"`` prefill and paged decode match the
  reference step for step, with the same tokens, positions, block tables
  and scatter targets on both sides, for smollm-135m and qwen3-4b
  (``qk_norm``) reduced, and a custom config whose q/o projections are
  square (H * head_dim == d_model, where a missing transpose would pass
  every shape check):
  - fp32 pages: logits and pages to 2e-5 — both sides compute in fp32
    and differ only in summation order (the algorithm; measured <= 5e-6);
  - bf16 pages (the serving default): logits to 1e-3 (measured <= 1.1e-4)
    and pages to one bf16 ulp (rtol 2^-7) plus the logits' 1e-3 — a K/V
    value a rounding apart in fp32 can land one bf16 ulp apart, and the
    layers after it see (and write) hidden states ~1e-4 apart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import get_config as jget_config
from repro.models.model import get_model as jget_model
from repro.models.steps import (make_chunked_prefill_step as j_chunk_step,
                                make_paged_serve_step as j_decode_step)
from repro.serving.kvpool import PagePool as JPool
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.steps import (make_chunked_prefill_step,
                                      make_paged_serve_step)
from repro_torch.serving.kvpool import PagePool as TPool

SQUARE = dict(name="square-smoke", family="dense", num_layers=3,
              d_model=192, num_heads=6, num_kv_heads=2, head_dim=32,
              d_ff=256, vocab_size=512, tie_embeddings=True)
ARCHS = ["smollm-135m", "qwen3-4b", "square"]
LOGIT_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=1e-3, atol=1e-3)}
PAGE_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
            "bfloat16": dict(rtol=2 ** -7, atol=1e-3)}


def _cfgs(arch):
    if arch == "square":
        return JConfig(**SQUARE), TConfig(**SQUARE)
    return jget_config(arch).reduced(), tget_config(arch).reduced()


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_exact(dtype):
    jcfg, tcfg = _cfgs("qwen3-4b")
    ref = _np_tree(jget_model(jcfg).init(jax.random.PRNGKey(1), dtype))
    port = bridge.from_reference(tcfg, ref)
    assert len(port["layers"]) == tcfg.num_layers
    want_dt = torch.float32 if dtype == "float32" else torch.bfloat16
    for i, layer in enumerate(port["layers"]):
        wq = layer["mixer"]["wq"]
        assert wq.dtype == want_dt
        ref_wq = ref["blocks"]["slot0"]["mixer"]["wq"][i]
        assert np.array_equal(_bits(bridge.to_numpy(wq, ref_wq)),
                              _bits(ref_wq))
    back = bridge.to_reference(tcfg, port, ref)
    flat_ref, tree_ref = jax.tree.flatten(ref)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree_ref == tree_back
    for a, b in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_exact_for_ssm_layers(dtype):
    jcfg = jget_config("mamba2-370m").reduced()
    tcfg = tget_config("mamba2-370m").reduced()
    ref = _np_tree(jget_model(jcfg).init(jax.random.PRNGKey(2), dtype))
    port = bridge.from_reference(tcfg, ref)
    for i, layer in enumerate(port["layers"]):
        assert set(layer) == {"mixer"}                  # no MLP
        for name in ("A_log", "dt_bias", "conv_x", "wdt"):
            want = ref["blocks"]["slot0"]["mixer"][name][i]
            assert np.array_equal(
                _bits(bridge.to_numpy(layer["mixer"][name], want)),
                _bits(want))
    back = bridge.to_reference(tcfg, port, ref)
    flat_ref, tree_ref = jax.tree.flatten(ref)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree_ref == tree_back
    for a, b in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))


def test_ssm_dense_cache_round_trip_is_bit_exact():
    """A mamba2 cache the reference filled with a prefill: its bf16
    ``conv`` and fp32 ``h`` leaves cross to the port's per-layer
    ``{"conv", "h"}`` dicts and back bit for bit."""
    jcfg = jget_config("mamba2-370m").reduced()
    tcfg = tget_config("mamba2-370m").reduced()
    jmodel = jget_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(4), "float32")
    toks = np.random.default_rng(4).integers(1, jcfg.vocab_size, (2, 21))
    cache = jmodel.init_cache(2, 32, dtype=jnp.bfloat16)
    _, cache, _ = jmodel.forward(params, tokens=jnp.asarray(toks),
                                 mode="full", cache=cache)
    like = _np_tree(cache)
    port = bridge.dense_cache_from_reference(tcfg, like)
    assert len(port) == tcfg.num_layers
    for layer in port:
        assert layer["conv"].dtype == torch.bfloat16
        assert layer["h"].dtype == torch.float32
        assert layer["conv"].any() and layer["h"].any()
    back = bridge.dense_cache_to_reference(tcfg, port, like)
    flat_ref, tree_ref = jax.tree.flatten(like)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree_ref == tree_back
    for a, b in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))


def test_port_init_follows_reference_tables():
    """Same tree, shapes and dtypes as the reference's init; norms start
    at zero, the embedding at scale 0.02, projections at fan_in^-1/2; the
    same seed gives the same weights."""
    jcfg, tcfg = _cfgs("smollm-135m")
    ref = _np_tree(jget_model(jcfg).init(jax.random.PRNGKey(0), "float32"))
    model = tget_model(tcfg)
    p = model.init(seed=3, device="cpu")
    back = bridge.to_reference(tcfg, p, ref)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
    lay = p["layers"][0]
    assert not lay["mixer"]["ln"].any() and not p["final_norm"].any()
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    fan = tcfg.d_model ** -0.5
    assert abs(float(lay["mixer"]["wq"].std()) - fan) < 0.1 * fan
    q = model.init(seed=3, device="cpu")
    assert torch.equal(p["embed"], q["embed"])
    assert torch.equal(p["layers"][-1]["mlp"]["w_down"],
                       q["layers"][-1]["mlp"]["w_down"])


def _tt(a, dtype=torch.int32):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_logits_match_reference(arch, kv_dtype):
    """Two chunk-prefill dispatches (two rows, a padded run, a scratch-
    masked write) then three paged decode steps (one idle scratch row)."""
    jcfg, tcfg = _cfgs(arch)
    jmodel, tmodel = jget_model(jcfg), tget_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), "float32")
    tparams = bridge.from_reference(tcfg, _np_tree(jparams))
    jdt = jnp.float32 if kv_dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if kv_dtype == "float32" else torch.bfloat16
    jpool = JPool(jmodel, max_len=96, page_size=16, num_pages=12, dtype=jdt)
    tpool = TPool(tmodel, max_len=96, page_size=16, num_pages=12, dtype=tdt,
                  device="cpu")
    jpages, tpages = jpool.pages, tpool.pages
    jchunk, jdec = jax.jit(j_chunk_step(jmodel)), jax.jit(
        j_decode_step(jmodel))
    tchunk, tdec = make_chunked_prefill_step(tmodel), \
        make_paged_serve_step(tmodel)
    rng = np.random.default_rng(5)
    V = tcfg.vocab_size
    tol = LOGIT_TOL[kv_dtype]

    chunks = [  # (tokens, starts, block table, dst pages, real rows/len)
        (rng.integers(3, V, (2, 32)), [0, 0], [[1, 2], [3, 4]],
         [[1, 2], [3, 4]], [32, 32]),
        (rng.integers(3, V, (2, 32)), [32, 32], [[1, 2, 5, 0], [3, 4, 6, 7]],
         [[5, 0], [6, 7]], [16, 32]),
    ]
    for tok, start, bt, dst, real in chunks:
        args = [np.asarray(x, np.int32) for x in (tok, start, bt, dst)]
        jl, jpages = jchunk(jparams, jpages, *[jnp.asarray(a) for a in args])
        tl, tpages = tchunk(tparams, tpages, *[_tt(a) for a in args])
        for r, n in enumerate(real):
            np.testing.assert_allclose(tl[r, :n].numpy(),
                                       np.asarray(jl)[r, :n], **tol)
    bt = np.asarray([[1, 2, 5, 9, 0], [3, 4, 6, 7, 8], [0] * 5], np.int32)
    for k in range(3):
        tok = rng.integers(3, V, (3, 1)).astype(np.int32)
        pos = np.asarray([48 + k, 64 + k, 0], np.int32)
        jl, jpages = jdec(jparams, jpages, jnp.asarray(tok),
                          jnp.asarray(pos), jnp.asarray(bt))
        tl, tpages = tdec(tparams, tpages, _tt(tok), _tt(pos), _tt(bt))
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   **tol)
    # the K/V written onto every real page agree as well
    jk = np.asarray(jax.tree.leaves(jpages)[0], np.float32)  # (L, P, ...)
    for i, layer in enumerate(tpages):
        np.testing.assert_allclose(layer["k_pages"][1:10].float().numpy(),
                                   jk[i, 1:10], **PAGE_TOL[kv_dtype])
