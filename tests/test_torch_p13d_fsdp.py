"""P13d: the reference's ZeRO-3 placement (its dry-run ``--fsdp``) in the
port: weights and AdamW state split over "pod"/"data" as ``apply_fsdp``
places them on the reference's stacked layout, gathered a layer at a
time (``sharding.fsdp_gather``) and their gradients summed back to each
rank's slice in the backward.

One gloo group of four ranks runs for the module (``launch.mesh.
RankGroup``; every case is a job on it) over two meshes: (data 2, model
2) and (pod 2, data 2, model 1). The parent, the only process that
imports JAX, computes the reference's side. Configs at ``.reduced()``
(MoE configs at capacity_factor 8: nothing dropped) with ``apply_fsdp``'s
``min_size`` lowered to ``MIN_SIZE``, so that a repeating group's norm
scales, (n, 256) stacked, split as the reference splits them at full
width; the production-mesh case keeps the default ``2**16``.

* Placement, shapes only: for all 10 configs at full width on the
  16 x 16 and 2 x 16 x 16 stand-in meshes, ``sharding.placed_axes`` of
  every leaf is the reference's ``apply_fsdp`` on its stacked tree
  (mapped through the bridge's layer order, the "layers" entry
  dropped), and a device's weight bytes are equal.
* Leaves, both meshes: every param ``Model.init`` and
  ``bridge.shard_params`` keep, and every moment
  ``bridge.opt_state_from_reference`` places (a factored state
  included), is the slice of the whole tensor the reference's axes give
  at the rank's coordinate (sliced here independently of the port's
  ``local_slice``); ``init_opt_state`` makes the same shapes, and the
  state gathers back to the reference's tree bit for bit.
* Serving: a prefill and 4 decode steps give logits bit-equal to the
  same mesh without FSDP (a gather is exact) and within P13c's
  tolerance of the reference (rtol/atol 3e-4, the reference's own).
* Training: two AdamW steps, remat off and on. Step 1's loss and every
  gathered gradient are bit-equal to the same mesh without FSDP (each
  element a sum of the same two data ranks' values, in either order);
  step 2's loss and norm hold to it at 1e-5 relative (the clip norm's
  squares summed in another grouping). Against the reference's
  ``make_train_step``: loss, norm and rate to 1e-5 relative, the
  gathered parameters to 2e-3 of the rate and every moment to 1e-4 of
  its largest magnitude, the tolerances of ``test_torch_factored_
  moment.py`` (eps 1e-4 as there). kimi-k2 takes the factored moment:
  its FFN weights split over "data" on the dim a row or column mean
  reduces, and its norm scales split in the group statistics.
* Double counting: the step with the FSDP leaves summed again gives
  exactly twice their gradients, which the comparison above catches,
  with an unchanged loss.
* Launcher: ``--mesh 2x2 --fsdp`` writes a global checkpoint that a
  one-process run resumes (its re-save bit-equal, its next step within
  P13a's launcher tolerance), and ``--mesh 2x1 --fsdp`` (spawned by the
  launcher) resumes a one-process checkpoint and re-saves it bit-equal.

This module imports no JAX at its top: the ranks import it.
"""
import functools
import os
import queue
import shutil
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from repro_torch import bridge, sharding
from repro_torch.configs.base import ARCH_IDS
from repro_torch.configs.base import get_config as tget_config
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import RankGroup, make_local_mesh
from repro_torch.models import steps as tsteps
from repro_torch.models.model import get_model as tget_model
from repro_torch.training import optim as toptim
from test_torch_p13c_placement import (DECODE_TOL, _jref, _numpy_ref,
                                       _port_decode, _ref_decode, _tcfg,
                                       _toks)

JOB_TIMEOUT = 180.0
MIN_SIZE = 256
LR = 1e-2
MESHES = {"2x2": dict(data=2, model=2), "2x2x1": dict(pod=2, data=2,
                                                      model=1)}


def _ocfg(mod, factored):
    return mod.AdamWConfig(lr=LR, eps=1e-4, warmup_steps=1, total_steps=10,
                           factored=factored)


# ------------------------------------------------------------ the group

@functools.lru_cache(maxsize=None)
def _mesh(shape):
    """The job's mesh over all four ranks (made once a rank, in the same
    order on all)."""
    if shape == "2x2":
        return make_local_mesh(2, 2, "cpu")
    return make_local_mesh(2, 1, "cpu", pod=2)


def _serve(jobs, done, outdir):
    rank = dist.get_rank()
    torch.set_num_threads(1)
    for shape in MESHES:
        _mesh(shape)
    while True:
        job = jobs[rank].get()
        if job is None:
            return None
        jid, name, shape, kw = job
        try:
            out = globals()[name](_mesh(shape) if shape else None, **kw)
            np.savez(os.path.join(outdir, f"{jid}_{rank}.npz"), **out)
            done.put((jid, rank, None))
        except Exception:
            done.put((jid, rank, traceback.format_exc()))


class Group:
    world = 4

    def __init__(self, outdir):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.outdir = str(outdir)
        self.jobs = [ctx.Queue() for _ in range(self.world)]
        self.done = ctx.Queue()
        self.ranks = RankGroup(_serve, self.world, backend="gloo",
                               args=(self.jobs, self.done, self.outdir))
        self.next_id = 0
        self.broken = None

    def submit(self, name, shape, **kw):
        """Start job ``name`` on the ``shape`` mesh; call the returned
        function for the ranks' result dicts."""
        if self.broken:
            pytest.fail(f"the group failed earlier: {self.broken}")
        jid = self.next_id
        self.next_id += 1
        for q in self.jobs:
            q.put((jid, name, shape, kw))
        return lambda: self._collect(jid, name)

    def _collect(self, jid, name):
        errors = []
        for _ in range(self.world):
            try:
                got, rank, err = self.done.get(timeout=JOB_TIMEOUT)
            except queue.Empty:
                self.broken = f"job {name} timed out"
                self.ranks.close()
                pytest.fail(f"{name}: no answer within {JOB_TIMEOUT} s")
            assert got == jid
            if err:
                errors.append(f"rank {rank}: {err}")
        if errors:
            self.broken = f"job {name} raised"
            self.ranks.close()
            pytest.fail("\n".join(errors))
        out = []
        for r in range(self.world):
            with np.load(os.path.join(self.outdir, f"{jid}_{r}.npz")) as z:
                out.append({k: z[k] for k in z.files})
        return out

    def close(self):
        if not self.broken:
            for q in self.jobs:
                q.put(None)
            self.ranks.join(JOB_TIMEOUT)
        self.ranks.close()


@pytest.fixture(scope="module")
def group(tmp_path_factory, lean_cpu):
    g = Group(tmp_path_factory.mktemp("p13d"))
    yield g
    g.close()


# ------------------------------------------------------------- reference

class Mesh:
    """The reference tests' stand-in mesh: only ``.shape``."""

    def __init__(self, **shape):
        self.shape = shape


def _ref_placed(jcfg, mesh, min_size):
    """The reference's ``apply_fsdp`` axes on its stacked tree, in the
    port's layout (``bridge``'s layer order; a stacked leaf's "layers"
    entry dropped): a tree like ``Model.axes()``."""
    from repro import sharding as jsharding
    from repro.models.model import get_model
    jm = get_model(jcfg)
    ax = jsharding.apply_fsdp(jm.abstract(), jm.axes(), mesh,
                              min_size=min_size)
    shapes = jm.abstract()
    out = {k: tuple(v) for k, v in ax.items() if not isinstance(v, dict)}
    out["layers"] = []
    for key, g in bridge._layer_order(jcfg, shapes):
        if g is None:
            out["layers"].append(_tuples(ax[key]))
        else:
            out["layers"].append(_tuples(ax["blocks"][key], drop=1))
    return out


def _tuples(tree, drop=0):
    return {k: (_tuples(v, drop) if isinstance(v, dict) else
                tuple(v)[drop:]) for k, v in tree.items()}


def _jcfg(arch):
    """The reference's config of ``_tcfg(arch)``."""
    return _jref(arch)[0].cfg


def _axes_list(axes):
    """The axes tuples of an axes tree, in ``tree_leaves`` order."""
    if isinstance(axes, dict):
        return [a for k in sorted(axes) for a in _axes_list(axes[k])]
    if isinstance(axes, list):
        return [a for v in axes for a in _axes_list(v)]
    return [tuple(axes)]


def _spec_list(jcfg, tmodel, mesh, min_size):
    """Every leaf's reference PartitionSpec (a tuple of axis tuples) on
    ``mesh``, in the port's ``tree_leaves`` order."""
    from repro import sharding as jsharding
    shapes = toptim.tree_leaves(tmodel.abstract())
    return [tuple(() if e is None else ((e,) if isinstance(e, str)
                                        else tuple(e))
                  for e in jsharding.resolve_spec(tuple(s.shape), ax, mesh))
            for s, ax in zip(shapes, _axes_list(
                _ref_placed(jcfg, mesh, min_size)))]


# ------------------------------------------------------- numpy slicing

def _coord(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _slice(a, spec, coord, sizes):
    """The slice of the whole array ``a`` a rank at ``coord`` holds under
    ``spec`` (per dim, the mesh axes splitting it, major first)."""
    for dim, axes in enumerate(spec):
        idx, n = 0, 1
        for ax in axes:
            idx, n = idx * sizes[ax] + coord[ax], n * sizes[ax]
        step = a.shape[dim] // n
        a = np.take(a, np.arange(idx * step, (idx + 1) * step), axis=dim)
    return a


def _state_specs(spec, factored, rank):
    """The reference's ``state_axes`` on one leaf's spec: ``m`` and
    ``v`` as the leaf, a factored leaf's ``vr`` without its last dim and
    ``vc`` without its second-to-last."""
    if factored and rank >= 2:
        return {"m": spec, "vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
    return {"m": spec, "v": spec}


def _ref_state(arch, factored):
    """A reference AdamW state tree (numpy, seeded draws into the
    reference's own layout), built without JAX: its ``mu`` mirrors the
    reference's params, ``{"m", "v"}`` or, factored, ``{"m", "vr",
    "vc"}`` at a leaf of rank 2 or more in that layout."""
    rng = np.random.default_rng(3)

    def one(a):
        s = a.shape
        if factored and len(s) >= 2:
            shapes = {"m": s, "vr": s[:-1], "vc": s[:-2] + s[-1:]}
        else:
            shapes = {"m": s, "v": s}
        return {k: rng.standard_normal(v).astype(np.float32)
                for k, v in shapes.items()}

    def walk(tree):
        return {k: (walk(tree[k]) if isinstance(tree[k], dict)
                    else one(tree[k])) for k in sorted(tree)}
    return {"mu": walk(_numpy_ref(arch)), "step": np.int32(3)}


# ------------------------------------------------------------- rank jobs

def rank_place(mesh, arch, specs, factored):
    """Leaves (init, shard_params, the placed state) that are not the
    reference's slice at this rank, and the state's round trip."""
    cfg = _tcfg(arch)
    model = tget_model(cfg)
    coord, sizes = _coord(mesh), sharding.mesh_shape(mesh)
    whole = model.init(seed=0, device="cpu")
    ref = _numpy_ref(arch)
    ref_state = _ref_state(arch, factored)
    ocfg = _ocfg(toptim, factored)
    with sharding.axis_rules(mesh, fsdp=True, min_size=MIN_SIZE):
        kept = model.init(seed=0, device="cpu")
        shard = bridge.shard_params(cfg, ref, mesh)
        state = bridge.opt_state_from_reference(cfg, ref_state, mesh=mesh,
                                                opt_cfg=ocfg)
        zeros = tsteps.init_opt_state(model, ocfg, kept)
        back = bridge.opt_state_to_reference(cfg, state, ref_state,
                                             mesh=mesh, opt_cfg=ocfg)
    bad = []
    full = bridge.from_reference(cfg, ref)
    for i, (spec, w, k, f, s) in enumerate(zip(
            specs, toptim.tree_leaves(whole), toptim.tree_leaves(kept),
            toptim.tree_leaves(full), toptim.tree_leaves(shard))):
        if not np.array_equal(_slice(w.numpy(), spec, coord, sizes),
                              k.numpy()):
            bad.append(f"init {i}")
        if not np.array_equal(_slice(f.numpy(), spec, coord, sizes),
                              s.numpy()):
            bad.append(f"shard {i}")
    whole_s = bridge.opt_state_from_reference(cfg, ref_state)
    n_split = sum(any(ax in ("pod", "data") for e in spec for ax in e)
                  for spec in specs)
    ranks = toptim.tree_leaves(tsteps.reference_ranks(model, whole))
    for i, (spec, rank, m, got, z) in enumerate(zip(
            specs, ranks, _moments(whole_s["mu"]), _moments(state["mu"]),
            _moments(zeros["mu"]))):
        want = _state_specs(spec, factored, rank)
        for key in got:
            sl = _slice(m[key].numpy(), want[key], coord, sizes)
            if not np.array_equal(sl, got[key].numpy()) or \
                    tuple(z[key].shape) != sl.shape:
                bad.append(f"state {i} {key}")
    for g, (layers, stats) in enumerate(zip(
            tsteps.stacked_groups(model) if factored else (),
            whole_s.get("groups", ()))):
        for path in toptim.vector_paths(whole["layers"][layers[0]]):
            spec = _spec_at(model, specs, layers[0], path)
            mine = toptim.at(state["groups"][g], path)
            for key, sp in (("vr", ((),)), ("vc", spec)):
                sl = _slice(toptim.at(stats, path)[key].numpy(), sp, coord,
                            sizes)
                if not np.array_equal(sl, mine[key].numpy()):
                    bad.append(f"groups {g} {path} {key}")
    same = all(np.array_equal(a, b) for a, b in zip(
        _np_leaves(back), _np_leaves(ref_state)))
    return {"bad": np.array(bad, dtype=str), "n_split": np.int64(n_split),
            "round_trip": np.bool_(same)}


def _moments(mu):
    """The moment dicts of a state's ``mu``, in the params' leaf order."""
    if isinstance(mu, dict) and "m" in mu and not isinstance(mu["m"], dict):
        return [mu]
    if isinstance(mu, dict):
        return [x for k in sorted(mu) for x in _moments(mu[k])]
    return [x for v in mu for x in _moments(v)]


def _np_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    return [np.asarray(tree)]


def _spec_at(model, specs, layer, path):
    """The spec of layer ``layer``'s leaf at ``path``."""
    leaves = [tuple(p) for p in _paths(model.axes())]
    return specs[leaves.index(("layers", str(layer)) + tuple(path))]


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                          prefix + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, prefix + (str(i),))]
    return [prefix]


def rank_forward(mesh, arch):
    """The prefill and decode logits, gathered, with and without FSDP."""
    cfg = _tcfg(arch)
    toks = torch.from_numpy(_toks(cfg))
    out = {}
    for fsdp in (False, True):
        with sharding.axis_rules(mesh, fsdp=fsdp, min_size=MIN_SIZE):
            params = bridge.shard_params(cfg, _numpy_ref(arch), mesh)
            lg = _port_decode(cfg, params, sharding.local_slice(
                toks, ("batch", None)))
            out[f"fsdp{int(fsdp)}"] = sharding.gather_global(
                lg, ("batch", None, None), (toks.shape[0],) +
                tuple(lg.shape[1:])).numpy()
    out["gathers"] = np.int64(sum(
        c for (kind, _), (c, _) in sharding.fsdp_gather.counts.items()
        if kind == "gathers"))
    return out


def _batches(cfg):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        t = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        out.append({"tokens": t, "labels": t})
    return out


def _gathered(model, tree, axes):
    return toptim.tree_map(
        lambda t, ax, s: sharding.gather_global(t, ax, s.shape), tree, axes,
        model.abstract())


def rank_train(mesh, arch, factored, remat, double=False):
    """Step 1's loss and gathered gradients (those the train step takes),
    and two AdamW steps, with and without FSDP; rank 0 also returns the
    FSDP run's gathered params and its state in the reference's layout.
    ``double`` sums the FSDP leaves' gradients again (the fault the step
    must not make) and takes step 1's gradients alone."""
    cfg = _tcfg(arch)
    model = tget_model(cfg)
    ocfg = _ocfg(toptim, factored)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches(cfg)]
    out = {}
    real_vg, real_leaves = tsteps.value_and_grad, tsteps.fsdp_leaves
    for fsdp in (False, True):
        with sharding.axis_rules(mesh, fsdp=fsdp, min_size=MIN_SIZE):
            params = bridge.shard_params(cfg, _numpy_ref(arch), mesh)
            first = []

            def captured(*args, **kw):
                first.append(real_vg(*args, **kw))
                return first[-1]
            tsteps.value_and_grad = captured
            if double and fsdp:
                tsteps.fsdp_leaves = lambda m: [False] * len(real_leaves(m))
            try:
                if double:
                    tsteps.value_and_grad(model, params, batches[0], remat)
                else:
                    state = tsteps.init_opt_state(model, ocfg, params)
                    step = tsteps.make_train_step(model, ocfg, remat=remat)
                    metrics = []
                    for b in batches:
                        params, state, m = step(params, state, b)
                        metrics.append([float(m[k]) for k in (
                            "loss", "grad_norm", "lr")])
                    out[f"metrics{int(fsdp)}"] = np.array(metrics)
            finally:
                tsteps.value_and_grad = real_vg
                tsteps.fsdp_leaves = real_leaves
            loss, _, grads = first[0]
            g = toptim.tree_leaves(_gathered(model, grads,
                                             sharding.placed_axes(model)))
            out[f"loss{int(fsdp)}"] = loss.numpy()
            out[f"grads{int(fsdp)}"] = np.concatenate(
                [x.reshape(-1).numpy() for x in g])
            if not fsdp:
                continue
            out["fsdp_mask"] = np.concatenate([
                np.full(x.numel(), split)
                for x, split in zip(g, tsteps.fsdp_leaves(model))])
            if double:
                continue
            # gathered on every rank (collectives); rank 0 returns them
            full = _gathered(model, params, sharding.placed_axes(model))
            js = bridge.opt_state_to_reference(
                cfg, state, _ref_state(arch, factored), mesh=mesh,
                opt_cfg=ocfg)
            if dist.get_rank() == 0:
                for i, t in enumerate(toptim.tree_leaves(full)):
                    out[f"p{i}"] = t.numpy()
                for i, a in enumerate(_np_leaves(js["mu"])):
                    out[f"s{i}"] = a
    return out


def rank_launch(mesh, argv):
    hist = tlaunch.main(argv)
    return {"loss": np.array([h["loss"] for h in hist]),
            "step": np.array([h["step"] for h in hist])}


# ------------------------------------------------------------- the cases

@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placement_is_apply_fsdp_on_the_stacked_tree(arch, multi_pod):
    """At full width and the default min_size: every leaf's placed axes
    are the reference's, and so are a device's weight bytes."""
    import math

    from repro.configs.base import get_config
    from repro_torch.launch.dryrun import param_bytes
    mesh = (Mesh(pod=2, data=16, model=16) if multi_pod
            else Mesh(data=16, model=16))
    jcfg = get_config(arch)
    want = _ref_placed(jcfg, mesh, sharding.FSDP_MIN_SIZE)
    model = tget_model(tget_config(arch))
    got = sharding.placed_axes(model, mesh, fsdp=True)
    assert _axes_list(got) == _axes_list(want)
    assert got is sharding.placed_axes(model, mesh, fsdp=True)   # made once
    assert any("fsdp" in a for a in _axes_list(got))
    specs = _spec_list(jcfg, model, mesh, sharding.FSDP_MIN_SIZE)
    dt = getattr(torch, jcfg.dtype)
    nbytes = sum(math.prod(s.shape) // math.prod(
        math.prod(mesh.shape[a] for a in e) for e in spec) *
        torch.empty((), dtype=dt).element_size()
        for s, spec in zip(toptim.tree_leaves(model.abstract()), specs))
    assert param_bytes(model, dt, mesh, fsdp=True,
                       rules=sharding.DEFAULT_RULES) == nbytes


LEAF_ARCHS = {"kimi-k2-1t-a32b": True, "mamba2-370m": False,
              "recurrentgemma-9b": False}


@pytest.mark.parametrize("shape", list(MESHES))
def test_every_leaf_and_moment_is_the_placed_slice(group, shape):
    jobs = {}
    for arch, factored in LEAF_ARCHS.items():
        specs = _spec_list(_jcfg(arch), tget_model(_tcfg(arch)),
                           Mesh(**MESHES[shape]), MIN_SIZE)
        jobs[arch] = group.submit("rank_place", shape, arch=arch,
                                  specs=specs, factored=factored)
    for arch, job in jobs.items():
        for o in job():
            assert o["bad"].size == 0, (arch, o["bad"][:8])
            assert bool(o["round_trip"]), arch
            # the (pod x data) split reaches norms and 2-D weights alike
            assert int(o["n_split"]) >= 6, arch


SERVE_ARCHS = ["qwen3-4b", "deepseek-v2-lite-16b", "mamba2-370m"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_are_the_mesh_without_fsdp(group, arch):
    job = group.submit("rank_forward", "2x2", arch=arch)
    jm, jp, _ = _jref(arch)
    want = _ref_decode(jm, jp, _toks(_tcfg(arch)))
    for o in job():
        assert np.array_equal(o["fsdp1"], o["fsdp0"]), arch
        np.testing.assert_allclose(o["fsdp1"], want, **DECODE_TOL)
        assert int(o["gathers"]) > 0


@functools.lru_cache(maxsize=None)
def _ref_train(arch, factored):
    """The reference's two steps from the same weights: (metrics (2, 3),
    params, state), numpy."""
    import jax
    from repro.models.steps import make_train_step
    from repro.training import optim as joptim
    jm, jp, _ = _jref(arch)
    ocfg = _ocfg(joptim, factored)
    js = joptim.init_state(ocfg, jp)
    step = jax.jit(make_train_step(jm, ocfg, remat=False))
    metrics = []
    for b in _batches(_tcfg(arch)):
        jp, js, m = step(jp, js, {k: jax.numpy.asarray(v)
                                  for k, v in b.items()})
        metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    return (np.array(metrics), jax.tree.map(np.asarray, jp),
            jax.tree.map(np.asarray, js))


TRAIN = [("kimi-k2-1t-a32b", True, "2x2"), ("qwen3-4b", False, "2x2x1")]


@pytest.mark.parametrize("remat", [False, True], ids=["remat0", "remat1"])
@pytest.mark.parametrize("arch,factored,shape", TRAIN,
                         ids=[a for a, _, _ in TRAIN])
def test_two_train_steps(group, arch, factored, shape, remat):
    job = group.submit("rank_train", shape, arch=arch, factored=factored,
                       remat=remat)
    want_m, jp, js = _ref_train(arch, factored)
    cfg = _tcfg(arch)
    outs = job()
    for o in outs:
        assert np.array_equal(o["loss1"], o["loss0"]), arch
        assert np.array_equal(o["grads1"], o["grads0"]), arch
        assert o["metrics1"][0, 0] == o["metrics0"][0, 0], arch
        np.testing.assert_allclose(o["metrics1"], o["metrics0"], rtol=1e-5,
                                   atol=0)
        np.testing.assert_allclose(o["metrics1"], want_m, rtol=1e-5,
                                   atol=1e-7)
    got = outs[0]
    for i, w in enumerate(toptim.tree_leaves(bridge.from_reference(cfg,
                                                                   jp))):
        assert float(np.abs(got[f"p{i}"] - w.numpy()).max()) <= 2e-3 * LR
    want_s = _np_leaves(js["mu"])
    assert len(want_s) == len([k for k in got if k.startswith("s")])
    for i, w in enumerate(want_s):
        assert got[f"s{i}"].shape == w.shape, i
        assert float(np.abs(got[f"s{i}"] - w).max()) <= \
            1e-4 * float(np.abs(w).max()) + 1e-9, i


def test_a_gradient_summed_twice_is_caught(group):
    """``value_and_grad`` with the FSDP leaves all-reduced over "data"
    again after their reduce-scatter: the loss is unchanged and so is
    every other leaf's gradient, but each FSDP leaf's is wrong (the
    ranks' different slices of an already summed gradient added up),
    which the bit-equality of ``test_two_train_steps`` catches."""
    outs = group.submit("rank_train", "2x2", arch="qwen3-4b",
                        factored=False, remat=False, double=True)()
    for o in outs:
        assert np.array_equal(o["loss1"], o["loss0"])
        good, bad, split = o["grads0"], o["grads1"], o["fsdp_mask"]
        assert 0 < split.mean() < 1
        assert np.array_equal(bad[~split], good[~split])
        assert np.abs(bad[split] - good[split]).max() > \
            0.1 * np.abs(good[split]).max()


LAUNCH = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
          "--log-every", "1", "--batch", "4", "--seq", "32"]
# P13a's launcher tolerance: two ranks' half-batch gradients summed
# against one batch's (summation order only), AdamW at eps 1e-8
LAUNCH_TOL = dict(rtol=2e-5, atol=0)


def _same_checkpoint(a, b):
    with np.load(os.path.join(a, "arrays.npz")) as x, \
            np.load(os.path.join(b, "arrays.npz")) as y:
        return sorted(x.files) == sorted(y.files) and all(
            np.array_equal(x[k], y[k]) for k in x.files)


def test_launcher_checkpoints_cross_fsdp(group, tmp_path):
    a, b, c = (str(tmp_path / n) for n in "abc")
    step2 = "step_00000002"
    # 2x2 with FSDP over the group's four ranks, checkpoints at 2 and 3
    outs = group.submit("rank_launch", None, argv=LAUNCH + [
        "--steps", "3", "--mesh", "2x2", "--fsdp", "--ckpt-every", "2",
        "--ckpt-dir", a])()
    fsdp_loss = outs[0]["loss"]
    one = tlaunch.main(LAUNCH + ["--steps", "3"])
    np.testing.assert_allclose(fsdp_loss, [h["loss"] for h in one],
                               **LAUNCH_TOL)
    # one process re-saves the FSDP checkpoint bit for bit ...
    shutil.copytree(os.path.join(a, step2), os.path.join(c, step2))
    tlaunch.main(LAUNCH + ["--steps", "2", "--resume", "--ckpt-dir", c])
    assert _same_checkpoint(os.path.join(a, step2), os.path.join(c, step2))
    # ... and resumes it
    shutil.rmtree(os.path.join(a, "step_00000003"))
    back = tlaunch.main(LAUNCH + ["--steps", "3", "--resume",
                                  "--ckpt-dir", a])
    assert [h["step"] for h in back] == [3]
    np.testing.assert_allclose(back[0]["loss"], fsdp_loss[2], **LAUNCH_TOL)
    # the reverse: --mesh 2x1 --fsdp (spawned by the launcher) resumes a
    # one-process checkpoint and re-saves it bit for bit
    tlaunch.main(LAUNCH + ["--steps", "2", "--ckpt-dir", b])
    shutil.copytree(os.path.join(b, step2), os.path.join(c, "b", step2))
    tlaunch.main(LAUNCH + ["--steps", "2", "--mesh", "2x1", "--fsdp",
                           "--resume", "--ckpt-dir", os.path.join(c, "b")])
    assert _same_checkpoint(os.path.join(b, step2),
                            os.path.join(c, "b", step2))
    with pytest.raises(SystemExit, match="--mesh"):
        tlaunch.main(LAUNCH + ["--fsdp"])
