"""The factored second moment (``AdamWConfig(factored=True)``) in the
port's train step, held to the reference's.

The reference factors every leaf of rank 2 or more in its stacked layout
(``repro/training/optim.py``): a pattern group's layers stacked along a
leading dim, so a grouped layer's 1-D leaves (norm weights, ``dt_bias``
and the like) take row statistics a layer and column statistics across
the group's layers. The port keeps them once a group
(``state["groups"]``, ``models.steps.stacked_groups``).

* Two train steps with ``factored=True`` on kimi-k2-1t-a32b and
  deepseek-v2-lite-16b ``.reduced()`` (a dense head layer, then MoE
  layers) and on qwen3-4b ``.reduced()`` (two grouped dense layers)
  against the reference's ``make_train_step``: loss, gradient norm and
  rate each step to 1e-5 relative, the parameters to 2e-3 of the rate
  and every ``m``/``vr``/``vc`` (mapped to the reference's stacked
  layout by ``bridge.opt_state_to_reference``) to 1e-4 of its largest
  magnitude, the tolerances of ``test_torch_train_step.py``'s AdamW
  steps (fp32 gradients summed in another order; eps 1e-4 as there). The
  reference's state carried across (``opt_state_from_reference``) gives
  the same tree.
* ``state_axes`` equals the reference's, leaf for leaf, in its layout.
* A checkpoint of the factored params and state round-trips bit-equal.
* Under a 1x2 mesh of two gloo ranks (heads, ff, vocab and experts split
  over "model") two factored steps equal one process: loss and gradient
  norm to 1e-5 relative, the gathered parameters to 2e-3 of the rate
  (fp32 sums over "model" in another order, which AdamW's per-element
  scaling turns into up to a share of the rate on small elements).

One torch thread (``_torch_parity.lean_cpu``), so the gloo ranks and
the other test workers do not spin against each other. This module
imports no JAX at its top: the gloo ranks import it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from repro_torch import bridge, checkpoint, sharding
from repro_torch.configs.base import get_config as tget_config
from repro_torch.launch.mesh import make_local_mesh, run_ranks
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.steps import (init_opt_state, make_train_step,
                                      stacked_groups)
from repro_torch.training import optim as toptim

ARCHS = ["kimi-k2-1t-a32b", "deepseek-v2-lite-16b", "qwen3-4b"]
LR = 1e-2
STEPS = 2


def _ocfg(mod):
    return mod.AdamWConfig(lr=LR, eps=1e-4, warmup_steps=1, total_steps=10,
                           factored=True)


def _batch(cfg, seed, B=2, S=24):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": t, "labels": t}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def run(request, lean_cpu):
    """Both packages' two factored steps from the same weights: the
    reference's params and state (numpy) and the port's."""
    import jax
    from repro.configs.base import get_config as jget_config
    from repro.models.model import get_model as jget_model
    from repro.models.steps import make_train_step as jmake_train_step
    from repro.training import optim as joptim
    name = request.param
    jcfg, tcfg = jget_config(name).reduced(), tget_config(name).reduced()
    jmodel, tmodel = jget_model(jcfg), tget_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(0), "float32")
    tp = bridge.from_reference(tcfg, jax.tree.map(np.asarray, jp))
    jocfg, tocfg = _ocfg(joptim), _ocfg(toptim)
    js = joptim.init_state(jocfg, jp)
    ts = init_opt_state(tmodel, tocfg, tp)
    jstep = jax.jit(jmake_train_step(jmodel, jocfg, remat=False))
    tstep = make_train_step(tmodel, tocfg, remat=False)
    metrics = []
    for i in range(STEPS):
        batch = _batch(tcfg, 20 + i)
        jp, js, jm = jstep(jp, js, {k: jax.numpy.asarray(v)
                                    for k, v in batch.items()})
        tp, ts, tm = tstep(tp, ts, _torch_batch(batch))
        metrics.append(({k: float(jm[k]) for k in ("loss", "grad_norm",
                                                     "lr")},
                        {k: float(tm[k]) for k in ("loss", "grad_norm",
                                                     "lr")}))
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, jmodel=jmodel,
                tmodel=tmodel, jp=jax.tree.map(np.asarray, jp),
                js=jax.tree.map(np.asarray, js), tp=tp, ts=ts,
                metrics=metrics, jocfg=jocfg, tocfg=tocfg)


def test_factored_steps_match_the_reference(run):
    for i, (want, got) in enumerate(run["metrics"]):
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]) + 1e-7, (
                run["name"], i, k, got[k], want[k])
    want_p = bridge.from_reference(run["tcfg"], run["jp"])
    for w, g in zip(toptim.tree_leaves(want_p),
                    toptim.tree_leaves(run["tp"])):
        assert float((g - w).abs().max()) <= 2e-3 * LR, run["name"]
    got_s = bridge.opt_state_to_reference(run["tcfg"], run["ts"], run["js"])
    n = 0
    for w, g in zip(_flat(run["js"]["mu"]), _flat(got_s["mu"])):
        assert w[0] == g[0] and w[1].shape == g[1].shape, (w[0], g[0])
        assert float(np.abs(g[1] - w[1]).max()) <= \
            1e-4 * float(np.abs(w[1]).max()) + 1e-9, (run["name"], w[0])
        n += 1
    assert n == len(_flat(run["js"]["mu"]))
    assert any(p.endswith("/vr") for p, _ in _flat(run["js"]["mu"]))
    assert int(got_s["step"]) == int(run["js"]["step"]) == STEPS


def test_reference_state_carries_across(run):
    carried = bridge.opt_state_from_reference(run["tcfg"], run["js"])
    assert sorted(carried) == sorted(run["ts"])
    a, b = toptim.tree_leaves(carried), toptim.tree_leaves(run["ts"])
    assert len(a) == len(b)
    for w, g in zip(a, b):
        assert w.shape == g.shape
        assert float((g.float() - w.float()).abs().max()) <= \
            1e-4 * float(w.float().abs().max()) + 1e-9
    # and back: the reference's tree, bit for bit
    back = bridge.opt_state_to_reference(run["tcfg"], carried, run["js"])
    for w, g in zip(_flat(run["js"]), _flat(back)):
        assert w[0] == g[0] and np.array_equal(w[1], g[1]), w[0]


def test_state_axes_match_the_reference(run):
    from repro.training import optim as joptim
    want = joptim.state_axes(run["jocfg"], run["jmodel"].axes())
    got = toptim.state_axes(run["tocfg"], run["tmodel"].axes(),
                            stacked_groups(run["tmodel"]))
    assert _axes_to_reference(run["tcfg"], got, run["jmodel"]) == \
        _plain(want)


def test_checkpoint_round_trip_is_bit_equal(run, tmp_path):
    tree = {"params": run["tp"], "state": run["ts"]}
    checkpoint.save(tmp_path, tree, step=STEPS)
    like = toptim.tree_map(torch.empty_like, tree)
    back = checkpoint.restore(tmp_path / f"step_{STEPS:08d}", like)
    a, b = toptim.tree_leaves(tree), toptim.tree_leaves(back)
    assert len(a) == len(b) and len(run["ts"]["groups"]) >= 1
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------- under a mesh

def _steps(arch, mesh):
    """Two factored steps of ``arch`` ``.reduced()`` (capacity_factor 8:
    nothing dropped) from seed 0, under ``mesh`` if given: (metrics, the
    params gathered into the global layout)."""
    cfg = dataclasses.replace(tget_config(arch).reduced(),
                              capacity_factor=8.0)
    model = tget_model(cfg)
    ocfg = _ocfg(toptim)
    out = []
    with sharding.axis_rules(mesh):
        params = model.init(seed=0, device="cpu")
        state = init_opt_state(model, ocfg, params)
        step = make_train_step(model, ocfg, remat=False)
        for i in range(STEPS):
            params, state, m = step(params, state,
                                    _torch_batch(_batch(cfg, 30 + i)))
            out.append([float(m["loss"]), float(m["grad_norm"])])
        full = toptim.tree_map(
            lambda t, ax, s: sharding.gather_global(t, ax, s.shape), params,
            model.axes(), model.abstract())
    return np.array(out), [t.numpy() for t in toptim.tree_leaves(full)]


def rank_steps(arch):
    return _steps(arch, make_local_mesh(1, 2, "cpu"))


def test_factored_step_under_a_mesh_equals_one_process(lean_cpu):
    arch = "kimi-k2-1t-a32b"
    outs = run_ranks(rank_steps, 2, args=(arch,), timeout=300)
    want_m, want_p = _steps(arch, None)
    for got_m, got_p in outs:
        np.testing.assert_allclose(got_m, want_m, rtol=1e-5, atol=0)
        for g, w in zip(got_p, want_p):
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * LR)


# ------------------------------------------------------------- helpers

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _flat(tree[k],
                                                         f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree))]


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tuple(tree)


def _axes_to_reference(cfg, axes, jmodel):
    """The port's state axes in the reference's layout: a grouped layer's
    per-layer axes take the stacked "layers" dim first, a grouped 1-D
    leaf's ``vr``/``vc`` come from its group."""
    from repro_torch.bridge import _layer_order
    mu = axes["mu"]
    out = {k: _plain(v) for k, v in mu.items() if k != "layers"}
    blocks = {}
    for (key, g), layer in zip(_layer_order(cfg, jmodel.abstract()),
                               mu["layers"]):
        if g is None:
            out[key] = _plain(layer)
        elif g == 0:
            s = int(key[4:])
            blocks[key] = _stack_axes(layer, axes["groups"][s])
    if blocks:
        out["blocks"] = blocks
    return {"mu": out, "step": ()}


def _stack_axes(layer, stats):
    if "m" in layer and not isinstance(layer["m"], dict):
        st = {k: ("layers",) + tuple(v) for k, v in layer.items()}
        if "v" not in layer and "vr" not in layer:      # a grouped vector
            st.update({k: tuple(v) for k, v in stats.items()})
        return st
    return {k: _stack_axes(v, stats.get(k, {})) for k, v in layer.items()}
