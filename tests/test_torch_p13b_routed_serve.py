"""The port's routed serve step (P13b: WAVES routing inside the decode
step) against the reference's ``launch/routed_serve.py``, and on two
gloo ranks against one process.

* The reference's own ``build`` (its ``make_production_mesh`` replaced by
  a one-device (1, 1, 1) mesh, ``get_config`` by qwen3-4b ``.reduced()``
  in fp32, a small decode shape put into ``SHAPES``), compiled and called
  on inputs drawn with numpy from a seed, in both variants. The port's
  ``make_routed_step`` with no mesh on the same inputs: logits within the
  decode tolerance of the port's parity tests (``DECODE_TOL``), ``assign``
  and the router's new state exactly, the returned cache (left in routed
  order with ``migrate_cache``) equal to the reference's except at the
  slot the step writes, where the bf16 K/V may round one unit in the
  last place apart.
* ``run`` on two spawned gloo ranks as a (pod 2, data 1, model 1) mesh,
  both variants, against ``run`` in this process with no mesh: the
  gathered logits within ``DECODE_TOL``, ``assign`` and the router state
  exactly, the gathered final caches to ``CACHE_TOL``; at least a
  quarter of the rows change rank at some step; each rank's permutation
  all-reduces and their bytes equal the count from the shapes.

This module imports no JAX at its top: the spawned ranks import it to
find their function.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import bridge, sharding
from repro_torch.configs.base import get_config as tget_config
from repro_torch.launch import routed_serve as trs
from repro_torch.launch.mesh import make_local_mesh, run_ranks
from repro_torch.models.model import get_model as tget_model

ARCH = "qwen3-4b"
DECODE_TOL = dict(rtol=3e-4, atol=3e-4)
# fp32 K/V projections of O(1) values, summed in another order on each
# side (as in tests/test_torch_distributed.py)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
B, S, POS = 8, 32, 21               # the reference comparison's decode shape
PROMPT, MAX_LEN, STEPS = 8, 32, 3    # the two-rank run
RANK_TIMEOUT = 300.0


def _cfg():
    return dataclasses.replace(tget_config(ARCH).reduced(), dtype="float32")


# ------------------------------------------------ against the reference

def _reference_step(monkeypatch, migrate):
    """The reference's compiled routed step and its config."""
    import jax
    from jax.sharding import AxisType
    jax.devices()      # the backend is up: the import's XLA_FLAGS are inert
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.configs.base import SHAPES, InputShape
    from repro.launch import routed_serve as jrs
    cfg = dataclasses.replace(jrs.get_config(ARCH).reduced(),
                              dtype="float32")
    monkeypatch.setattr(jrs, "get_config", lambda a: cfg)
    # Auto axes: this JAX makes Explicit ones by default, which the
    # reference's sharding constraints refuse
    monkeypatch.setattr(
        jrs, "make_production_mesh", lambda **kw: jax.make_mesh(
            (1, 1, 1), ("pod", "data", "model"),
            axis_types=(AxisType.Auto,) * 3))
    monkeypatch.setitem(SHAPES, "tiny_decode",
                        InputShape("tiny_decode", S, B, "decode"))
    lowered, _ = jrs.build(ARCH, "tiny_decode", migrate)
    return lowered.compile(), cfg


def _inputs(cfg, seed=0):
    """Numpy draws: fp32 weights into the reference's tree, a bf16 cache,
    tokens, sensitivities; the island tables as the port packs them."""
    import jax
    import ml_dtypes
    from repro.models.model import get_model
    rng = np.random.default_rng(seed)
    model = get_model(cfg)

    def draw(s):
        scale = s.shape[-2] ** -0.5 if len(s.shape) >= 2 else 0.1
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    params = jax.tree.map(draw, model.abstract("float32"))
    cache = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(ml_dtypes.bfloat16),
        model.init_cache(B, S, abstract=True))
    token = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    sens = rng.uniform(0.0, 1.0, B).astype(np.float32)
    tbl, state = trs.island_tables()
    return params, cache, token, sens, tbl, state


@pytest.mark.parametrize("migrate", [False, True],
                         ids=["tokens_only", "migrate_cache"])
def test_routed_step_matches_reference(monkeypatch, migrate):
    import jax
    import jax.numpy as jnp
    from repro.core import routing_jax as rj
    compiled, jcfg = _reference_step(monkeypatch, migrate)
    params, cache, token, sens, tbl, state = _inputs(jcfg)
    w = np.asarray(trs.WEIGHTS, np.float32)
    jtbl = rj.IslandTable(**{f.name: jnp.asarray(getattr(tbl, f.name).numpy())
                             for f in dataclasses.fields(tbl)})
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    jlogits, jcache, jassign, jnew = compiled(
        params, cache, token, np.int32(POS), jtbl, sens, w, jstate)

    cfg = _cfg()
    tcache = bridge.dense_cache_from_reference(cfg, cache)
    step = trs.make_routed_step(tget_model(cfg), migrate)
    with torch.no_grad():
        logits, tcache, assign, new = step(
            bridge.from_reference(cfg, params), tcache,
            torch.from_numpy(token), torch.tensor(POS, dtype=torch.int32),
            tbl, torch.from_numpy(sens), torch.from_numpy(w), state)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **DECODE_TOL)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(jassign))
    assert set(new) == set(jnew)
    for k in new:
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(jnew[k]))
    want = bridge.dense_cache_from_reference(
        cfg, jax.tree.map(np.asarray, jcache))
    for g, w_ in zip(tcache, want):
        for k in w_:             # (B, S, Hkv, D)
            g_, wk = g[k].float().numpy(), w_[k].float().numpy()
            other = np.arange(S) != POS      # every slot but the written
            np.testing.assert_array_equal(g_[:, other], wk[:, other])
            # one bf16 unit in the last place, relative
            assert np.all(np.abs(g_[:, POS] - wk[:, POS])
                          <= 2.0 ** -7 * np.abs(wk[:, POS]))


# ------------------------------------------------------ on two gloo ranks

def _prompts_and_sens(cfg, seed=3):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return torch.from_numpy(prompts), torch.from_numpy(
        rng.uniform(0.0, 1.0, B).astype(np.float32))


def _gathered(out, model):
    """The run's results with this rank's rows gathered."""
    V = model.cfg.vocab_size
    logits = sharding.gather_global(
        out["logits"].transpose(0, 1).contiguous(), ("batch", None, None),
        (B, STEPS, V)).transpose(0, 1)
    cache = [{k: sharding.gather_global(
        c, ("batch",) + (None,) * (c.dim() - 1),
        (B,) + tuple(c.shape[1:])).float().numpy() for k, c in layer.items()}
        for layer in out["cache"]]
    return {"logits": logits.numpy(), "assign": out["assign"].numpy(),
            "state": {k: v.numpy() for k, v in out["state"].items()},
            "cache": cache}


def _rank_run():
    """On each rank: both variants under a (pod 2, data 1, model 1) mesh;
    the gathered results and the permutation's counters."""
    torch.set_num_threads(1)
    cfg = _cfg()
    model = tget_model(cfg)
    prompts, sens = _prompts_and_sens(cfg)
    mesh = make_local_mesh(1, 1, "cpu", pod=2)
    res = {}
    with sharding.axis_rules(mesh):
        params = model.init(seed=0, device="cpu")
        for migrate in (False, True):
            n0, b0 = trs.permute_rows.all_reduces, trs.permute_rows.bytes
            out = trs.run(model, params, prompts, sens, max_len=MAX_LEN,
                          steps=STEPS, migrate_cache=migrate)
            res[migrate] = dict(
                _gathered(out, model),
                all_reduces=trs.permute_rows.all_reduces - n0,
                bytes=trs.permute_rows.bytes - b0,
                local_rows=out["logits"].shape[1])
    return res


@pytest.fixture(scope="module")
def two_ranks():
    return run_ranks(_rank_run, 2, timeout=RANK_TIMEOUT)


def _crossings(assign):
    """Rows that change rank (of two) at each step."""
    out = []
    for a in assign:
        pod = np.where(a >= 0, a * 2 // 4, 0)
        inv = np.argsort(np.argsort(pod, kind="stable"), kind="stable")
        out.append(int(np.sum(np.arange(B) // (B // 2) != inv // (B // 2))))
    return out


@pytest.mark.parametrize("migrate", [False, True],
                         ids=["tokens_only", "migrate_cache"])
def test_two_gloo_ranks_match_one_process(two_ranks, migrate):
    cfg = _cfg()
    model = tget_model(cfg)
    prompts, sens = _prompts_and_sens(cfg)
    torch.set_num_threads(1)
    one = trs.run(model, model.init(seed=0, device="cpu"), prompts, sens,
                  max_len=MAX_LEN, steps=STEPS, migrate_cache=migrate)
    for rank in two_ranks:
        got = rank[migrate]
        assert got["local_rows"] == B // 2
        np.testing.assert_allclose(got["logits"], one["logits"].numpy(),
                                   **DECODE_TOL)
        np.testing.assert_array_equal(got["assign"], one["assign"].numpy())
        for k, v in one["state"].items():
            np.testing.assert_array_equal(got["state"][k], v.numpy())
        for g, w in zip(got["cache"], one["cache"]):
            for k in w:
                np.testing.assert_allclose(g[k], w[k].float().numpy(),
                                           **CACHE_TOL)
        # the permutation: per step the token and the logits, and with
        # migrate_cache every cache leaf, each one all-reduce over "pod"
        # (2 ranks: a ring all-reduce moves the global bytes once)
        leaves = [c for layer in one["cache"] for c in layer.values()]
        per_step = [B * 1 * 4, B * cfg.vocab_size * 4]
        if migrate:
            per_step += [c.numel() * c.element_size() for c in leaves]
        assert got["all_reduces"] == STEPS * len(per_step)
        assert got["bytes"] == STEPS * sum(per_step)
    assert max(_crossings(one["assign"].numpy())) >= B // 4
    assert len(set((one["assign"].numpy() * 2 // 4).ravel())) == 2
