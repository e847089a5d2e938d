"""P13c: weights and caches placed by the reference's logical-axis rules,
tensor parallel over "model", on gloo ranks on the CPU.

One gloo group of four ranks runs for the module (``launch.mesh.
RankGroup``; every case is a job on it): the 2x2 mesh over all four, the
1x2 mesh over ranks 0 and 1 (ranks 2 and 3 join its groups and return
nothing). The parent, the only process that imports JAX, holds the
ranks' results to the one-process port and to the reference on the same
numpy weights (``bridge.shard_params``). Configs at ``.reduced()``, whose
head counts, ff, vocab, ssm_heads and lru the model axis of 2 divides:
qwen3-4b, mamba2-370m, recurrentgemma-9b (kv heads 1: q split, K/V whole,
its windowed cache sequence-sharded), deepseek-v2-lite-16b (MLA, latent
cache sequence-sharded) and kimi-k2-1t-a32b (capacity_factor 8 for both
MoE configs: nothing dropped).

* Placement, 1x2 and 2x2: every leaf ``Model.init`` keeps under the mesh
  equals ``sharding.local_slice`` of the one-process leaf under
  ``DEFAULT_RULES`` (bit for bit), and so does ``bridge.shard_params``;
  every cache leaf of ``init_cache`` has the rules' local shape (Mamba-2's
  conv tail: the rank's channels, the recorded deviation).
* Forward: a prefill and 4 decode steps on an fp32 cache; the gathered
  logits against the one-process port to 3e-5 (fp32 partial products
  summed over "model" in another order; measured under 4e-6) and against
  the reference's single-device decode at rtol/atol 3e-4 (the
  reference's own tolerance, as the P13a tests).
* Training, 1x2: two AdamW steps (eps 1e-4, as the train-step parity
  tests) equal one process: loss and gradient norm to 1e-5 relative, the
  gathered parameters to 2e-3 of the rate, the train-step parity tests'
  bound (AdamW divides each element by its own gradient's scale, so a
  small element's fp32 summation noise moves its update by a share of
  the rate: 2.8e-6 at a rate of 1e-2 measured).
* Unchanged: smollm-135m ``.reduced()`` at its full head counts (9 q, 3
  kv), which the model axis divides neither: q, k and v are gathered
  whole, the cache is sequence-sharded, and the logits hold to the
  reference as the P13a decode did (3e-4), every layer of every decode
  step through the sequence-sharded region.

This module imports no JAX at its top: the ranks import it.
"""
import dataclasses
import functools
import os
import queue
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from repro_torch import bridge, sharding
from repro_torch.configs.base import get_config as tget_config
from repro_torch.launch.mesh import RankGroup, make_local_mesh
from repro_torch.models import decode_sharded
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.steps import make_train_step
from repro_torch.training import optim as toptim

JOB_TIMEOUT = 180.0
ARCHS = ["qwen3-4b", "mamba2-370m", "recurrentgemma-9b",
         "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]
MOE = {"capacity_factor": 8.0}
DECODE_TOL = dict(rtol=3e-4, atol=3e-4)
PORT_TOL = dict(rtol=3e-5, atol=3e-5)
B, S, T, L = 2, 20, 4, 24
LR = 1e-2


def _changes(arch):
    if arch == "smollm-9-3":
        return "smollm-135m", {"num_heads": 9, "num_kv_heads": 3}
    return arch, (MOE if tget_config(arch).num_experts else {})


def _tcfg(arch):
    name, changes = _changes(arch)
    return dataclasses.replace(tget_config(name).reduced(), **changes)


# ------------------------------------------------------------ the group

@functools.lru_cache(maxsize=None)
def _mesh(shape):
    """The job's mesh (made once a rank, in the same order on all)."""
    from torch.distributed.device_mesh import DeviceMesh
    if shape == "2x2":
        return make_local_mesh(2, 2, "cpu")
    return DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                      mesh_dim_names=("data", "model"))


def _serve(jobs, done, outdir):
    rank = dist.get_rank()
    torch.set_num_threads(1)
    while True:
        job = jobs[rank].get()
        if job is None:
            return None
        jid, name, shape, kw = job
        try:
            mesh = _mesh(shape)
            out = ({} if mesh.get_coordinate() is None
                   else globals()[name](mesh, **kw))
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
        function for the member ranks' result dicts."""
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
                if z.files:
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
    g = Group(tmp_path_factory.mktemp("p13c"))
    yield g
    g.close()


# ------------------------------------------------------------- reference

@functools.lru_cache(maxsize=None)
def _jref(arch):
    """The reference's model, fp32 params and their numpy tree: numpy
    draws into its abstract tree (vectors at 0.1, so that norm weights
    are not all zero)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.models.model import get_model
    name, changes = _changes(arch)
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    model = get_model(cfg)
    rng = np.random.default_rng(0)

    def draw(s):
        scale = s.shape[-2] ** -0.5 if len(s.shape) >= 2 else 0.1
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    ref = jax.tree.map(draw, model.abstract("float32"))
    return model, jax.tree.map(jnp.asarray, ref), ref


def _toks(cfg, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + T)).astype(np.int32)


def _ref_decode(model, params, toks):
    import jax
    import jax.numpy as jnp
    cache = model.init_cache(B, L, dtype=jnp.float32)
    prefill = jax.jit(lambda p, c, t: model.forward(p, mode="full", cache=c,
                                                    tokens=t)[:2])
    decode = jax.jit(lambda p, c, t, pos: model.forward(
        p, mode="decode", tokens=t, cache=c, pos=pos)[:2])
    lg, cache = prefill(params, cache, jnp.asarray(toks[:, :S]))
    out = [np.asarray(lg[:, -1])]
    for t in range(T):
        lg, cache = decode(params, cache, jnp.asarray(toks[:, S + t:S + t + 1]),
                           jnp.int32(S + t))
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, 1)


def _port_decode(cfg, params, toks):
    """The port's prefill + T decode steps (under the current mesh, on
    this rank's rows): logits (B_loc, T + 1, V)."""
    model = tget_model(cfg)
    cache = model.init_cache(toks.shape[0], L, dtype=torch.float32,
                             device="cpu")
    lg, cache = model.forward(params, mode="full", cache=cache,
                              tokens=toks[:, :S])
    out = [lg[:, -1]]
    for t in range(T):
        lg, cache = model.forward(params, mode="decode", cache=cache,
                                  tokens=toks[:, S + t:S + t + 1],
                                  pos=S + t)
        out.append(lg[:, 0])
    return torch.stack(out, 1)


def _batches(cfg):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        t = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        out.append({"tokens": t, "labels": t})
    return out


def _train(cfg, params):
    """Two AdamW steps: (metrics (2, 2), the params)."""
    model = tget_model(cfg)
    ocfg = toptim.AdamWConfig(lr=LR, eps=1e-4, warmup_steps=0)
    state = toptim.init_state(ocfg, params)
    step = make_train_step(model, ocfg, remat=False)
    out = []
    for b in _batches(cfg):
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in b.items()})
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return np.array(out), params


# ------------------------------------------------------------- rank jobs

def rank_place(mesh, archs):
    """Per config: leaves whose local tensor is not the rules' slice of
    the one-process leaf (``init`` and ``shard_params``), caches whose
    local shape is not the rules', and the leaves counted."""
    out = {}
    for arch in archs:
        cfg = _tcfg(arch)
        model = tget_model(cfg)
        whole = model.init(seed=0, device="cpu")
        bad, n = [], 0
        with sharding.axis_rules(mesh):
            kept = model.init(seed=0, device="cpu")
            ref = _numpy_ref(arch)
            shard = bridge.shard_params(cfg, ref, mesh)
        full = bridge.from_reference(cfg, ref)
        for path, ax, w, k, f, s in zip(
                _paths(whole), _axes(model.axes()),
                toptim.tree_leaves(whole), toptim.tree_leaves(kept),
                toptim.tree_leaves(full), toptim.tree_leaves(shard)):
            want = sharding.local_slice(w, ax, mesh, sharding.DEFAULT_RULES)
            want_s = sharding.local_slice(f, ax, mesh,
                                          sharding.DEFAULT_RULES)
            if not (torch.equal(want, k) and torch.equal(want_s, s)):
                bad.append(path)
            n += 1
        with sharding.axis_rules(mesh):
            cache = model.init_cache(4, L, dtype=torch.float32,
                                     device="cpu")
            for i, (bt, layer) in enumerate(zip(model.block_types,
                                                model.cache_spec(4, L))):
                for name, (sh, ax) in layer.items():
                    want = sharding.local_shape(sh, ax, mesh,
                                                sharding.DEFAULT_RULES)
                    if bt == "ssm" and name == "conv":
                        split = cfg.ssm_heads % 2 == 0
                        want = want[:-1] + ((cfg.ssm_inner // 2 if split
                                             else cfg.ssm_inner)
                                            + 2 * cfg.ssm_state,)
                    if tuple(cache[i][name].shape) != want:
                        bad.append(f"cache/{i}/{name}")
            split = sum(sharding.is_sharded(s.shape, a)
                        for s, a in zip(toptim.tree_leaves(model.abstract()),
                                        _axes(model.axes())))
        out[arch] = np.array(bad, dtype=str)
        out[arch + "_n"] = np.int64(n)
        out[arch + "_split"] = np.int64(split)
    return out


def rank_forward(mesh, arch):
    cfg = _tcfg(arch)
    toks = torch.from_numpy(_toks(cfg))
    c0 = decode_sharded.seq_sharded_decode.calls
    with sharding.axis_rules(mesh):
        params = bridge.shard_params(cfg, _numpy_ref(arch), mesh)
        lg = _port_decode(cfg, params, sharding.local_slice(
            toks, ("batch", None)))
        lg = sharding.gather_global(lg, ("batch", None, None),
                                    (B,) + tuple(lg.shape[1:]))
    return {"logits": lg.numpy(),
            "seq_calls": np.int64(decode_sharded.seq_sharded_decode.calls
                                  - c0)}


def rank_train(mesh, arch):
    cfg = _tcfg(arch)
    model = tget_model(cfg)
    with sharding.axis_rules(mesh):
        params = bridge.shard_params(cfg, _numpy_ref(arch), mesh)
        metrics, params = _train(cfg, params)
        full = toptim.tree_map(
            lambda t, ax, s: sharding.gather_global(t, ax, s.shape), params,
            model.axes(), model.abstract())
    return {"metrics": metrics,
            **{f"p{i}": t.numpy()
               for i, t in enumerate(toptim.tree_leaves(full))}}


@functools.lru_cache(maxsize=None)
def _numpy_ref(arch):
    """The reference's numpy weights, drawn on a rank without JAX: the
    same draws into the port's mirror of the reference's abstract tree
    (``bridge.to_reference`` of meta shapes)."""
    cfg = _tcfg(arch)
    model = tget_model(cfg)
    like = _reference_like(cfg, model)
    rng = np.random.default_rng(0)

    def draw(shape):
        scale = shape[-2] ** -0.5 if len(shape) >= 2 else 0.1
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return _map_shapes(like, draw)


def _reference_like(cfg, model):
    """The reference's parameter tree of shapes, from the port's: its
    ``head_{i}``, ``blocks/slot{s}`` (stacked) and ``tail_{j}`` in the
    reference's sorted-key order."""
    shapes = model.abstract()
    out = {k: v for k, v in shapes.items() if k != "layers"}
    spans = model.layer_spans()
    grouped = [(lo, hi) for lo, hi, g in spans if g]
    heads = [lo for lo, hi, g in spans if not g and lo < cfg.first_dense_layers]
    tails = [lo for lo, hi, g in spans
             if not g and lo >= cfg.first_dense_layers]
    for i in heads:
        out[f"head_{i}"] = shapes["layers"][i]
    if grouped:
        out["blocks"] = {f"slot{s}": toptim.tree_map(
            lambda t, n=len(grouped): torch.empty((n,) + tuple(t.shape),
                                                  device="meta"),
            shapes["layers"][grouped[0][0] + s])
            for s in range(len(model.pattern))}
    for j, i in enumerate(tails):
        out[f"tail_{j}"] = shapes["layers"][i]
    return out


def _map_shapes(tree, fn):
    """``fn`` on each shape of a tree in ``jax.tree.leaves`` order
    (sorted keys), so that draws follow the reference's order."""
    return {k: (_map_shapes(tree[k], fn) if isinstance(tree[k], dict)
                else fn(tuple(tree[k].shape))) for k in sorted(tree)}


def _axes(axes):
    """The axes tuples of an axes tree, in ``tree_leaves`` order."""
    if isinstance(axes, dict):
        return [a for k in sorted(axes) for a in _axes(axes[k])]
    if isinstance(axes, list):
        return [a for v in axes for a in _axes(v)]
    return [axes]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                          f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]


# ------------------------------------------------------------- the cases

def test_numpy_draws_are_the_reference_tree():
    """The ranks draw the reference's weights without JAX: the same tree,
    shapes and numbers as ``_jref``'s."""
    import jax
    for arch in ARCHS + ["smollm-9-3"]:
        _, _, ref = _jref(arch)
        mine = _numpy_ref(arch)
        a, b = jax.tree.leaves(ref), jax.tree.leaves(mine)
        assert jax.tree.structure(ref) == jax.tree.structure(mine), arch
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), arch


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_every_leaf_is_the_rules_slice(group, shape):
    outs = group.submit("rank_place", shape, archs=ARCHS)()
    assert len(outs) == (2 if shape == "1x2" else 4)
    for o in outs:
        for arch in ARCHS:
            assert o[arch].size == 0, (arch, o[arch])
            assert int(o[arch + "_n"]) > 0
            # heads, ff, vocab (and experts, ssm_heads, lru) split
            assert int(o[arch + "_split"]) >= 4, arch


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_one_process_and_the_reference(
        group, shape, arch):
    job = group.submit("rank_forward", shape, arch=arch)
    jm, jp, ref = _jref(arch)
    cfg = _tcfg(arch)
    toks = _toks(cfg)
    want = _ref_decode(jm, jp, toks)
    one = _port_decode(cfg, bridge.from_reference(cfg, ref),
                       torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(one, want, **DECODE_TOL)
    for o in job():
        np.testing.assert_allclose(o["logits"], one, **PORT_TOL)
        np.testing.assert_allclose(o["logits"], want, **DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_one_process(group, arch):
    job = group.submit("rank_train", "1x2", arch=arch)
    cfg = _tcfg(arch)
    want_m, params = _train(cfg, bridge.from_reference(cfg,
                                                       _numpy_ref(arch)))
    want_p = toptim.tree_leaves(params)
    for o in job():
        np.testing.assert_allclose(o["metrics"], want_m, rtol=1e-5, atol=0)
        for i, w in enumerate(want_p):
            np.testing.assert_allclose(o[f"p{i}"], w.numpy(), rtol=0,
                                       atol=2e-3 * LR)


def test_head_counts_the_axis_does_not_divide(group):
    """smollm's 9 q and 3 kv heads on a model axis of 2: the projections'
    columns are the rules' (split mid-head) and gathered whole, the cache
    sequence-sharded, every decode layer through the seq-sharded region,
    the logits as P13a held them."""
    arch = "smollm-9-3"
    job = group.submit("rank_forward", "1x2", arch=arch)
    jm, jp, ref = _jref(arch)
    cfg = _tcfg(arch)
    want = _ref_decode(jm, jp, _toks(cfg))
    outs = job()
    assert len(outs) == 2
    for o in outs:
        np.testing.assert_allclose(o["logits"], want, **DECODE_TOL)
        assert int(o["seq_calls"]) == T * cfg.num_layers
