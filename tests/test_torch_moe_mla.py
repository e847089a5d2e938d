"""The port's MoE block (``models/moe.py``) and Multi-head Latent Attention
(``models/mla.py``) against the reference's, one layer at a time, on the
reference's seeded weights and inputs drawn from a numpy seed.

* ``moe_apply`` for kimi-k2-1t-a32b and deepseek-v2-lite-16b at
  ``.reduced()`` (deepseek with 0, 1 and 2 shared experts) over several
  (B, S): ``y`` and the aux loss to 1e-5 (both sides fp32; the expert
  products and the top-k combine sum in other orders, measured <= 1e-6),
  and the routing itself: the same experts, in the same order, where the
  k-th and (k+1)-th probabilities are not a near tie; the renormalised
  weights to 1e-6; ties broken toward the lower expert index, as
  ``jax.lax.top_k`` breaks them.
* ``mla_apply`` full mode at S 16, 1024 and 1536 (the reference runs
  ``attend_blocked`` above 1024, the port one pass at every length: the
  same function), output and the written latent cache; absorbed and
  naive decode against the reference's, and against each other (the
  port of tests/test_models.py::test_mla_absorbed_equals_naive, at its
  2e-4); a (B,) ``pos`` decode equal to B scalar decodes row for row,
  slot clamp included; fp32, bf16 and fp8 ``ckr`` caches cast as the
  reference casts them (no scale leaves).

Tolerances: fp32 outputs to 2e-5 (both sides fp32, summation order
only; measured <= 3e-6). A cache leaf the reference and the port round
to bf16 or fp8 from fp32 values ~1e-6 apart may land one ulp apart, so
cast leaves are held to one ulp of their dtype (2^-7 relative for bf16,
2^-2 for e4m3fn's three mantissa bits, 2^-1 for e5m2's two), with a
floor near zero, and at most 0.1% of their values apart (measured: 8
of 82,560 bf16 values at S 1024). Decode outputs that attend such a
cache are held to 1e-3, the bf16-page logit tolerance of
tests/test_torch_bridge_model.py (measured <= 7.3e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models.model import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models.model import get_model as tget_model

TOL = dict(rtol=2e-5, atol=2e-5)
ULP = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float8_e4m3fn": 2.0 ** -2,
       "float8_e5m2": 2.0 ** -1}
# near zero: the migration tests' 1e-4 floor, or fp8's smallest step
FLOOR = {"bfloat16": 1e-4, "float8_e4m3fn": 2.0 ** -9,
         "float8_e5m2": 1e-4}
# decode outputs over a cast cache whose values may sit one ulp apart:
# bf16's 1e-3 (tests/test_torch_bridge_model.py's bf16-page tolerance)
OUT_TOL = {"float32": TOL, "bfloat16": dict(rtol=1e-3, atol=1e-3),
           "float8_e4m3fn": dict(rtol=1e-3, atol=1e-3),
           "float8_e5m2": dict(rtol=1e-3, atol=1e-3)}
NEAR_TIE = 1e-6


def _cfgs(arch, **changes):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **changes)
    tcfg = dataclasses.replace(tget_config(arch).reduced(), **changes)
    return jcfg, tcfg


def _layer(jcfg, tcfg, seed=0):
    """The reference's seeded params and the port's bridged copy."""
    jp = jget_model(jcfg).init(jax.random.PRNGKey(seed), "float32")
    npp = jax.tree.map(np.asarray, jp)
    return npp, bridge.from_reference(tcfg, npp)


def _moe_params(npp, tp):
    """The reference's first MoE layer (group 0 of the stacked slot) and
    the port's layer 1 (layer 0 is the dense first layer)."""
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      npp["blocks"]["slot0"]["moe"])
    return jp, tp["layers"][1]["moe"]


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------------- MoE

MOE_CASES = [("kimi-k2-1t-a32b", None), ("deepseek-v2-lite-16b", 0),
             ("deepseek-v2-lite-16b", 1), ("deepseek-v2-lite-16b", 2)]


@pytest.mark.parametrize("arch,shared", MOE_CASES)
@pytest.mark.parametrize("B,S", [(1, 1), (2, 7), (3, 16)])
def test_moe_apply_matches_reference(arch, shared, B, S):
    changes = {} if shared is None else {"num_shared_experts": shared}
    jcfg, tcfg = _cfgs(arch, **changes)
    npp, tp = _layer(jcfg, tcfg)
    jp, p = _moe_params(npp, tp)
    assert ("shared" in p) == bool(tcfg.num_shared_experts)
    x = _x((B, S, tcfg.d_model), seed=B * 100 + S)
    jy, jaux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    y, aux = tmoe.moe_apply(tcfg, p, torch.from_numpy(x))
    assert y.shape == (B, S, tcfg.d_model) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "deepseek-v2-lite-16b"])
def test_routing_matches_reference(arch):
    """The router logits as the reference computes them (``x2 @ router``
    in the parameter dtype, then fp32), the same top-k experts in the
    same order, renormalised weights to 1e-6; a flipped expert is allowed
    only at a near tie, which is reported (none occurs here)."""
    jcfg, tcfg = _cfgs(arch)
    npp, tp = _layer(jcfg, tcfg)
    jp, p = _moe_params(npp, tp)
    x2 = _x((64, tcfg.d_model), seed=7)
    jlog = (jnp.asarray(x2) @ jp["router"]).astype(jnp.float32)
    tlog = torch.matmul(torch.from_numpy(x2), p["router"]).float()
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    k = tcfg.top_k
    jw, jidx, jprobs = jmoe._route(jlog, k)
    w, idx, probs = tmoe._route(tlog, k)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    srt = np.sort(np.asarray(jprobs), axis=-1)[:, ::-1]
    gap = srt[:, k - 1] - srt[:, k]
    near = gap <= NEAR_TIE
    assert not near.any(), f"near ties at rows {np.nonzero(near)[0]}"
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(tmoe._aux_loss(probs, idx, tcfg.num_experts)),
        float(jmoe._aux_loss(jprobs, jidx, jcfg.num_experts)), rtol=1e-6)


def test_topk_ties_break_toward_the_lower_index():
    """Equal probabilities: ``jax.lax.top_k`` returns the lower expert
    index first, and so does the port (``torch.topk`` leaves the order of
    ties unspecified). Rows of all-equal logits and of pairwise ties."""
    logits = np.array([[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                       [1.0, 2.0, 2.0, 1.0, 0.5, 2.0],
                       [3.0, 1.0, 3.0, 1.0, 1.0, 0.0]], np.float32)
    for k in (1, 2, 3, 4):
        jw, jidx, _ = jmoe._route(jnp.asarray(logits), k)
        w, idx, _ = tmoe._route(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)


def test_expert_ffn_broadcasts_without_copying_the_tokens():
    """(T, d) tokens against (E, d, f) experts equal the reference's
    ``broadcast_to(x2[None], (E, T, d))`` product, expert for expert."""
    jcfg, tcfg = _cfgs("kimi-k2-1t-a32b")
    npp, tp = _layer(jcfg, tcfg)
    jp, p = _moe_params(npp, tp)
    x2 = _x((5, tcfg.d_model), seed=3)
    E = tcfg.num_experts
    want = jmoe._expert_ffn(jp["we_gate"], jp["we_up"], jp["we_down"],
                            jnp.broadcast_to(jnp.asarray(x2)[None],
                                             (E,) + x2.shape))
    got = tmoe._expert_ffn(p["we_gate"], p["we_up"], p["we_down"],
                           torch.from_numpy(x2))
    assert got.shape == (E, 5, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------- MLA

def _mla(seed=0):
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b")
    npp, tp = _layer(jcfg, tcfg, seed)
    jp = jax.tree.map(jnp.asarray, npp["head_0"]["mixer"])
    return jcfg, tcfg, jp, tp["layers"][0]["mixer"]


def _width(cfg):
    return cfg.kv_lora_rank + cfg.rope_head_dim


def _jdtype(name):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
            "float8_e4m3fn": jnp.float8_e4m3fn,
            "float8_e5m2": jnp.float8_e5m2}[name]


def _cache_pair(cfg, B, S, dtype, seed=5, fill=True):
    """The same (B, S, 1, r + rd) latent cache in both packages: numpy
    normals cast to ``dtype`` once (ml_dtypes) and carried bit for bit."""
    a = (_x((B, S, 1, _width(cfg)), seed) if fill
         else np.zeros((B, S, 1, _width(cfg)), np.float32))
    a = a.astype(getattr(ml_dtypes, dtype) if dtype != "float32"
                 else np.float32)
    return {"ckr": jnp.asarray(a)}, {"ckr": _to_torch(a)}


def _to_torch(a):
    if a.dtype.itemsize == 1:            # fp8: carry the bits
        dt = {"float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}[a.dtype.name]
        return torch.from_numpy(a.view(np.uint8).copy()).view(dt)
    return bridge.to_torch(a)


def _as_f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t).astype(np.float32)


def _within_ulp(got, want, dtype):
    """Cast leaves: one ulp of ``dtype`` apart at most (or ``FLOOR``
    near zero, where fp32 values 1e-7 apart are many ulps apart), and
    at most 0.1% of the values apart at all; fp32 leaves to ``TOL``."""
    g, w = _as_f32(got), _as_f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, **TOL)
        return
    bound = np.maximum(ULP[dtype] * np.maximum(np.abs(g), np.abs(w)),
                       FLOOR[dtype])
    assert np.all(np.abs(g - w) <= bound), np.abs(g - w).max()
    assert (g != w).mean() <= 1e-3, (g != w).mean()


@pytest.mark.parametrize("S", [16, 1024, 1536])
def test_full_mode_matches_reference(S):
    """Full mode: q/k at D nope + rope, v at D v_head_dim, the RoPE key
    broadcast over the heads; with a bf16 cache, the prompt's latent in
    slots 0..S-1 and zeros past it."""
    jcfg, tcfg, jp, p = _mla()
    B = 2 if S == 16 else 1
    x = _x((B, S, tcfg.d_model), seed=S)
    pos = np.arange(S, dtype=np.int32)
    jc, tc = _cache_pair(tcfg, B, S + 8, "bfloat16", fill=False)
    jy, jnc = jmla.mla_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                             mode="full", cache=jc)
    y, tc = tmla.mla_apply(tcfg, p, torch.from_numpy(x),
                           torch.from_numpy(pos), mode="full", cache=tc)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    _within_ulp(tc["ckr"], jnc["ckr"], "bfloat16")
    assert not tc["ckr"][:, S:].float().any()
    y0, _ = tmla.mla_apply(tcfg, p, torch.from_numpy(x),
                           torch.from_numpy(pos), mode="full")
    assert torch.equal(y0, y)                 # the cache write is a side job


@pytest.mark.parametrize("decode_mode", ["absorbed", "naive"])
@pytest.mark.parametrize("pos", [0, 5, 11])
def test_decode_matches_reference(decode_mode, pos):
    """One decode token against an fp32 latent cache: the output and the
    new slot (written before attending) equal the reference's."""
    jcfg, tcfg, jp, p = _mla()
    B, S = 2, 12
    x = _x((B, 1, tcfg.d_model), seed=40 + pos)
    jc, tc = _cache_pair(tcfg, B, S, "float32")
    jy, jnc = jmla.mla_apply(jcfg, jp, jnp.asarray(x), jnp.int32(pos),
                             mode="decode", cache=jc,
                             decode_mode=decode_mode)
    y, tc = tmla.mla_apply(tcfg, p, torch.from_numpy(x), pos,
                           mode="decode", cache=tc, decode_mode=decode_mode)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tc["ckr"].numpy(), np.asarray(jnc["ckr"]),
                               **TOL)


def test_absorbed_equals_naive():
    """tests/test_models.py::test_mla_absorbed_equals_naive on the port:
    head_0's MLA, B 2, an fp32 cache of 8 normal slots, pos 7, 2e-4."""
    _, tcfg, _, p = _mla()
    B, S = 2, 8
    x = torch.from_numpy(_x((B, 1, tcfg.d_model), seed=0))
    _, tc = _cache_pair(tcfg, B, S, "float32", seed=5)
    y1, _ = tmla.mla_apply(tcfg, p, x, S - 1, mode="decode",
                           cache={"ckr": tc["ckr"].clone()},
                           decode_mode="absorbed")
    y2, _ = tmla.mla_apply(tcfg, p, x, S - 1, mode="decode",
                           cache={"ckr": tc["ckr"].clone()},
                           decode_mode="naive")
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("decode_mode", ["absorbed", "naive"])
def test_vector_pos_equals_scalar_decodes(decode_mode):
    """A (B,) ``pos`` decode equals B one-row decodes at each row's scalar
    position, row for row, and the reference's scalar decode of that row:
    each row writes slot min(pos, S-1) (pos 12 and 30 clamp to 11) and
    attends its own slots < pos + 1. Batched and one-row matmuls may
    block their sums differently: 2e-6 (measured bit-equal)."""
    jcfg, tcfg, jp, p = _mla()
    S = 12
    poss = [0, 4, 11, 12, 30]
    B = len(poss)
    x = _x((B, 1, tcfg.d_model), seed=9)
    jc, tc = _cache_pair(tcfg, B, S, "bfloat16")
    base = tc["ckr"].clone()
    y, tc = tmla.mla_apply(tcfg, p, torch.from_numpy(x),
                           torch.tensor(poss, dtype=torch.int32),
                           mode="decode", cache=tc, decode_mode=decode_mode)
    for b, pb in enumerate(poss):
        one = {"ckr": base[b:b + 1].clone()}
        yb, one = tmla.mla_apply(tcfg, p, torch.from_numpy(x[b:b + 1]), pb,
                                 mode="decode", cache=one,
                                 decode_mode=decode_mode)
        np.testing.assert_allclose(y[b:b + 1].numpy(), yb.numpy(),
                                   rtol=2e-6, atol=2e-6)
        _within_ulp(tc["ckr"][b:b + 1], one["ckr"], "bfloat16")
        jy, jnc = jmla.mla_apply(
            jcfg, jp, jnp.asarray(x[b:b + 1]), jnp.int32(pb), mode="decode",
            cache={"ckr": jc["ckr"][b:b + 1]}, decode_mode=decode_mode)
        np.testing.assert_allclose(yb.numpy(), np.asarray(jy), **TOL)
        _within_ulp(one["ckr"], jnc["ckr"], "bfloat16")
        slot = min(pb, S - 1)
        others = [s for s in range(S) if s != slot]
        assert torch.equal(tc["ckr"][b, others], base[b, others])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn",
                                   "float8_e5m2"])
def test_cache_dtypes_cast_as_the_reference(dtype):
    """A prompt in full mode, then two absorbed decode steps, into a
    latent cache of ``dtype``: the cache is a plain cast of the latent
    (fp8 included: no scale), each leaf within one ulp of the
    reference's, the decode outputs to ``OUT_TOL``; ``Model.init_cache`` builds a ``ckr`` of that dtype and no
    other leaf, as the reference's."""
    jcfg, tcfg, jp, p = _mla()
    B, S, W = 2, 10, 16
    x = _x((B, S + 2, tcfg.d_model), seed=11)
    jc, tc = _cache_pair(tcfg, B, W, dtype, fill=False)
    pos = np.arange(S, dtype=np.int32)
    jy, jc = jmla.mla_apply(jcfg, jp, jnp.asarray(x[:, :S]),
                            jnp.asarray(pos), mode="full", cache=jc)
    y, tc = tmla.mla_apply(tcfg, p, torch.from_numpy(x[:, :S]),
                           torch.from_numpy(pos), mode="full", cache=tc)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    _within_ulp(tc["ckr"], jc["ckr"], dtype)
    for t in range(2):
        xt = x[:, S + t:S + t + 1]
        jy, jc = jmla.mla_apply(jcfg, jp, jnp.asarray(xt), jnp.int32(S + t),
                                mode="decode", cache=jc)
        y, tc = tmla.mla_apply(tcfg, p, torch.from_numpy(xt), S + t,
                               mode="decode", cache=tc)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                   **OUT_TOL[dtype])
        _within_ulp(tc["ckr"], jc["ckr"], dtype)
    tdt = getattr(torch, dtype)
    jcache = jget_model(jcfg).init_cache(B, W, dtype=_jdtype(dtype))
    tcache = tget_model(tcfg).init_cache(B, W, dtype=tdt, device="cpu")
    assert all(set(layer) == {"ckr"} and layer["ckr"].dtype == tdt
               and layer["ckr"].shape == (B, W, 1, _width(tcfg))
               for layer in tcache)
    assert set(jcache["head_0"]["mixer"]) == {"ckr"}


def test_mla_refuses_paged_modes():
    """MLA has no chunk mode: its caches are dense (``paged_supported``
    is false for it in both packages)."""
    _, tcfg, _, p = _mla()
    x = torch.zeros(1, 16, tcfg.d_model)
    with pytest.raises(ValueError, match="chunk"):
        tmla.mla_apply(tcfg, p, x, torch.zeros(1, 16, dtype=torch.int32),
                       mode="chunk", cache={})
