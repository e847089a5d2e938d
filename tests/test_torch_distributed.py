"""The port's distributed slice (P13a) on gloo ranks on the CPU, held to
the reference on the same numpy inputs and bridged weights.

One gloo group per mesh shape (1x1, 1x2, 2x2) starts once for the module
(``launch.mesh.RankGroup``: spawned ranks joined through a ``FileStore``
in ``tmp_path``). Every case runs inside one of them: the parent puts a
job on each rank's queue, the ranks run the port under a mesh and write
their results as npz, and the parent (the only process that imports
JAX) holds them to the reference. A job that does not finish within
``JOB_TIMEOUT`` fails its case and stops the group. This module imports
no JAX at its top: the ranks import it to find their job functions.

* The sequence-sharded GQA decode (smollm-135m ``.reduced()``, kv heads
  2, on a 1x4 mesh, and kv heads 1 on 1x2): a prefill and 4 decode steps
  against the reference's single-device decode at rtol/atol 3e-4 (the
  reference's own tolerance, ``tests/test_system.py``), and the gathered
  caches against the reference's to 1e-5; at 2x2 (kv heads 2 divide the
  model axis) the rank's decode over its kv heads, its batch rows
  split. One
  layer's ``seq_sharded_decode`` against the reference's ``_inner`` under
  ``jax.vmap(axis_name="model")`` on the same local slots: each rank's
  updated slots and the merged output to 1e-6 (fp32, summation order),
  at a slot owned by each rank and on a ring; three all-reduces a call.
* MLA's seq-sharded latent decode (deepseek-v2-lite-16b ``.reduced()``,
  absorbed, 1x2, capacity_factor 8 so that no token is dropped) against
  the reference's single-device decode at 3e-4.
* The expert-parallel MoE (kimi-k2-1t-a32b ``.reduced()``): at the
  default capacity_factor 1.25 (tokens dropped) against the reference's
  ``_moe_local`` under nested ``vmap`` over "data" and "model" (1e-6);
  at capacity_factor 8 against ``_moe_dense`` (3e-4, aux 1e-3);
  ``_rank_within_expert`` exactly.
* The train step at 2x2 (kimi ``.reduced()``, capacity_factor 8): the
  loss to 1e-5 relative and every gradient leaf (experts gathered) to
  1e-4 of its largest magnitude plus 1e-7 against the reference's
  single-device ``jax.value_and_grad(loss_fn)``, the tolerances of
  ``tests/test_torch_train_step.py``.
* The train launcher with ``--mesh 2x1`` (spawning its ranks, and inside
  the 1x2 group) against the launcher without it, with a resume across
  the two both ways.
* An fp8 cache under a seq-sharding mesh decodes over the gathered
  cache, as the reference's (which skips the seq-sharded decode for a
  quantized cache), equal to the port's single-device fp8 decode.
* 1x1: the expert-parallel branch equals the dense one at
  capacity_factor 8, and smollm under the mesh equals no mesh exactly.
* The refusals, by their messages.
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

from repro_torch import bridge, sharding
from repro_torch.configs.base import get_config as tget_config
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import RankGroup, make_local_mesh
from repro_torch.models import decode_sharded, moe as tmoe
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.steps import value_and_grad
from repro_torch.training.optim import tree_leaves, tree_map

JOB_TIMEOUT = 180.0
SHAPES = {"1x1": (1, 1), "1x2": (1, 2), "2x2": (2, 2)}
DECODE_TOL = dict(rtol=3e-4, atol=3e-4)
# fp32 K/V projections of O(1) values over d_model terms: the two
# packages' matmuls sum in different orders (measured <= 3e-6)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- the groups

def _serve(jobs, done, outdir, d, m):
    """A rank's loop: run each job's function on this rank, write its
    result dict as npz, report; ``None`` ends the loop."""
    rank = dist.get_rank()
    mesh = make_local_mesh(d, m, "cpu")
    while True:
        job = jobs[rank].get()
        if job is None:
            return None
        jid, name, kw = job
        try:
            out = globals()[name](mesh, **kw)
            np.savez(os.path.join(outdir, f"{jid}_{rank}.npz"), **out)
            done.put((jid, rank, None))
        except Exception:
            done.put((jid, rank, traceback.format_exc()))


class Group:
    def __init__(self, shape, outdir):
        import torch.multiprocessing as mp
        d, m = SHAPES[shape]
        self.world = d * m
        self.outdir = str(outdir)
        ctx = mp.get_context("spawn")
        self.jobs = [ctx.Queue() for _ in range(self.world)]
        self.done = ctx.Queue()
        self.ranks = RankGroup(_serve, self.world, backend="gloo",
                               args=(self.jobs, self.done, self.outdir, d,
                                     m))
        self.next_id = 0
        self.broken = None

    def run(self, name, **kw):
        """Every rank's result dict for job ``name``."""
        return self.submit(name, **kw)()

    def submit(self, name, **kw):
        """Start job ``name`` on every rank; call the returned function
        for the ranks' result dicts (the parent computes the reference
        meanwhile)."""
        if self.broken:
            pytest.fail(f"the group failed earlier: {self.broken}")
        jid = self.next_id
        self.next_id += 1
        for q in self.jobs:
            q.put((jid, name, kw))
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
def groups(tmp_path_factory):
    """The three groups, started together."""
    gs = {s: Group(s, tmp_path_factory.mktemp(f"group{s}")) for s in SHAPES}
    yield gs
    for g in gs.values():
        g.close()


# ------------------------------------------------------------- reference

def _jref(arch, seed=0, **changes):
    return _jref_cached(arch, seed, tuple(sorted(changes.items())))


@functools.lru_cache(maxsize=None)
def _jref_cached(arch, seed, changes):
    """The reference's config, model, fp32 params and their numpy tree.
    The weights are numpy draws into the reference's own abstract tree
    (normal at fan_in^-1/2; vectors at 0.1, so that the norms' weights
    are not all zero): seeded like its ``init``, without compiling it."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.models.model import get_model
    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(changes))
    model = get_model(cfg)
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = s.shape[-2] ** -0.5 if len(s.shape) >= 2 else 0.1
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    ref = jax.tree.map(draw, model.abstract("float32"))
    return cfg, model, jax.tree.map(jnp.asarray, ref), ref


def _tcfg(arch, **changes):
    return dataclasses.replace(tget_config(arch).reduced(), **changes)


def _ref_decode(model, params, toks, S, T, L, cache_dtype="float32",
                decode_mode=None):
    """The reference's single-device prefill + T decode steps: logits of
    the last prompt row and of each step (B, T + 1, V), and the cache."""
    import jax
    import jax.numpy as jnp
    cache = model.init_cache(toks.shape[0], L, dtype=getattr(jnp,
                                                             cache_dtype))
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
    return np.stack(out, 1), cache


# ----------------------------------------------------------- rank jobs

@functools.lru_cache(maxsize=None)
def _make_mesh(d, m):
    return make_local_mesh(d, m, device="cpu")


def _sub_mesh(mesh, sub):
    """The job's mesh: the group's, or another shape over its ranks (made
    once a rank)."""
    return mesh if sub is None else _make_mesh(*sub)


def rank_decode(mesh, arch, ref, toks, S, T, L, sub=None,
                cache_dtype="float32", changes=None):
    """Prefill + T decode steps of the port under the mesh: the gathered
    logits (B, T + 1, V), the gathered caches and the collective counts."""
    mesh = _sub_mesh(mesh, sub)
    cfg = _tcfg(arch, **(changes or {}))
    model = tget_model(cfg)
    calls0 = decode_sharded.seq_sharded_decode.calls
    red0 = decode_sharded.seq_sharded_decode.all_reduces
    B = toks.shape[0]
    with sharding.axis_rules(mesh):
        params = bridge.shard_params(cfg, ref, mesh)
        cache = model.init_cache(B, L, dtype=getattr(torch, cache_dtype),
                                 device="cpu")
        local_bytes = sum(t.numel() * t.element_size()
                          for layer in cache for t in layer.values())
        tk = sharding.local_slice(torch.from_numpy(toks), ("batch", None))
        lg, cache = model.forward(params, mode="full", cache=cache,
                                  tokens=tk[:, :S])
        out = [lg[:, -1]]
        for t in range(T):
            lg, cache = model.forward(params, mode="decode", cache=cache,
                                      tokens=tk[:, S + t:S + t + 1],
                                      pos=S + t)
            out.append(lg[:, 0])
        logits = torch.stack(out, 1)
        res = {"logits": sharding.gather_global(
            logits, ("batch", None, None), (B,) + tuple(logits.shape[1:])),
            "local_bytes": np.int64(local_bytes)}
        for i, layer in enumerate(model.cache_spec(B, L)):
            for n, t in cache[i].items():
                # an fp8 cache's scales lie like its k/v without the last dim
                shape, axes = layer.get(n) or (layer["k"][0][:-1],
                                               layer["k"][1][:-1])
                res[f"cache{i}_{n}"] = sharding.gather_global(
                    t.float(), axes, shape)
    res["calls"] = decode_sharded.seq_sharded_decode.calls - calls0
    res["all_reduces"] = (decode_sharded.seq_sharded_decode.all_reduces
                          - red0)
    return {k: np.asarray(v) for k, v in res.items()}


def rank_inner(mesh, kc, vc, kn, vn, q, pos, window, scale, sub=None):
    """One ``seq_sharded_decode`` on this rank's slots of kc/vc."""
    mesh = _sub_mesh(mesh, sub)
    n = sharding.mesh_shape(mesh)["model"]
    r = mesh.get_local_rank("model")
    S_loc = kc.shape[1] // n
    loc = lambda a: torch.from_numpy(a[:, r * S_loc:(r + 1) * S_loc].copy())
    k_loc, v_loc = loc(kc), loc(vc)
    red0 = decode_sharded.seq_sharded_decode.all_reduces
    with sharding.axis_rules(mesh):
        _, _, o = decode_sharded.seq_sharded_decode(
            k_loc, v_loc, torch.from_numpy(kn), torch.from_numpy(vn),
            torch.from_numpy(q), pos, window, scale)
    return {"k": k_loc.numpy(), "v": v_loc.numpy(), "o": o.numpy(),
            "all_reduces": np.int64(
                decode_sharded.seq_sharded_decode.all_reduces - red0)}


def rank_moe(mesh, arch, p, x, cf):
    """``moe_apply`` on this rank's rows of x and its experts."""
    cfg = _tcfg(arch, capacity_factor=cf)
    with sharding.axis_rules(mesh):
        axes = tget_model(cfg).layer_table(1)["moe"]
        pl = {k: (sharding.local_slice(torch.from_numpy(v), axes[k].axes)
                  if not isinstance(v, dict) else
                  {kk: torch.from_numpy(vv) for kk, vv in v.items()})
              for k, v in p.items()}
        xl = sharding.local_slice(torch.from_numpy(x), ("batch", None, None))
        y, aux = tmoe.moe_apply(cfg, pl, xl)
        full = sharding.gather_global(y, ("batch", None, None), x.shape)
    return {"y": y.numpy(), "y_full": full.numpy(), "aux": aux.numpy()}


def rank_grads(mesh, arch, ref, batch, changes):
    """The train step's loss and gradients under the mesh, every leaf
    gathered into the global layout."""
    cfg = _tcfg(arch, **changes)
    model = tget_model(cfg)
    with sharding.axis_rules(mesh):
        params = bridge.shard_params(cfg, ref, mesh)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss, parts, grads = value_and_grad(model, params, tb)
        full = tree_map(
            lambda g, ax, s: sharding.gather_global(g, ax, s.shape),
            grads, model.axes(), model.abstract())
    out = {f"g{i}": g.numpy() for i, g in enumerate(tree_leaves(full))}
    out.update(loss=loss.numpy(), ce=parts["ce"].numpy(),
               aux=parts["aux"].numpy())
    return out


def rank_launch(mesh, argv):
    hist = tlaunch.main(argv)
    return {"loss": np.array([h["loss"] for h in hist]),
            "gnorm": np.array([h["grad_norm"] for h in hist]),
            "step": np.array([h["step"] for h in hist])}


def rank_refusals(mesh):
    """The messages of what the slice refuses, under this group, and what
    the placements it once refused now give."""
    msgs = {}

    def catch(key, fn):
        try:
            out = fn()
            msgs[key] = np.array("")
            return out
        except (ValueError, RuntimeError) as e:
            msgs[key] = np.array(str(e))

    catch("mesh", lambda: make_local_mesh(4, 2, "cpu"))
    cfg = _tcfg("smollm-135m")
    m14 = make_local_mesh(1, 4, "cpu")
    with sharding.axis_rules(m14):
        cache = catch("cache", lambda: tget_model(cfg).init_cache(
            2, 30, device="cpu"))
    if cache is not None:
        msgs["cache_shape"] = np.array(cache[0]["k"].shape)
        msgs["cache_split"] = np.array(
            isinstance(cache[0], decode_sharded.SeqSplitCache))
    kcfg = _tcfg("kimi-k2-1t-a32b", num_experts=6)
    with sharding.axis_rules(m14):
        p = tget_model(kcfg).init(seed=0, device="cpu")
        catch("experts", lambda: tmoe.moe_apply(
            kcfg, p["layers"][1]["moe"], torch.zeros(1, 4, kcfg.d_model)))
    with sharding.axis_rules(mesh):
        model = tget_model(cfg)
        params = model.init(seed=0, device="cpu")
        toks = torch.zeros(3, 8, dtype=torch.int32)
        got = catch("batch", lambda: value_and_grad(
            model, params, {"tokens": toks, "labels": toks}))
    if got is not None:
        msgs["batch_loss"] = got[0].numpy()
    return msgs


def rank_dtensor(mesh, x):
    """A DTensor view of this rank's shard (``to_dtensor``) gathers back
    to the global tensor; ``shard`` redistributes one by logical axes;
    ``gather_global`` inverts ``local_slice``."""
    from torch.distributed.tensor import Replicate, Shard
    t = torch.from_numpy(x)
    axes = ("batch", "kv_seq", None)
    with sharding.axis_rules(mesh):
        part = sharding.local_slice(t, axes)
        dt = sharding.to_dtensor(part, axes, t.shape)
        back = sharding.gather_global(part, axes, t.shape)
        moved = sharding.shard(dt, None, "experts", None)
        spec = sharding.named_sharding(t.shape, axes)
    return {"full": dt.full_tensor().numpy(), "back": back.numpy(),
            "moved": moved.full_tensor().numpy(),
            "moved_local": moved.to_local().numpy(),
            "placements": np.array(str(dt.placements)),
            "spec_placements": np.array(str(tuple(spec.placements))),
            "want_placements": np.array(str((Shard(0), Shard(1)))),
            "replicate": np.array(str(Replicate()))}


def rank_one_by_one(mesh, ref_s, toks, kref, x):
    """1x1: smollm under the mesh against no mesh (exact), and kimi's
    expert-parallel branch against the dense one at capacity_factor 8."""
    cfg = _tcfg("smollm-135m")
    model = tget_model(cfg)
    params = bridge.from_reference(cfg, ref_s)

    def run():
        cache = model.init_cache(toks.shape[0], 24, dtype=torch.float32,
                                 device="cpu")
        t = torch.from_numpy(toks)
        lg, cache = model.forward(params, mode="full", cache=cache,
                                  tokens=t[:, :20])
        out = [lg[:, -1]]
        for s in range(4):
            lg, cache = model.forward(params, mode="decode", cache=cache,
                                      tokens=t[:, 20 + s:21 + s],
                                      pos=20 + s)
            out.append(lg[:, 0])
        return torch.stack(out, 1)

    plain = run()
    with sharding.axis_rules(mesh):
        meshed = run()
    kcfg = _tcfg("kimi-k2-1t-a32b", capacity_factor=8.0)
    p = tree_map(torch.from_numpy, kref)
    xt = torch.from_numpy(x)
    y_d, aux_d = tmoe.moe_apply(kcfg, p, xt)
    calls = tmoe.moe_apply.all_reduces
    with sharding.axis_rules(mesh):
        y_e, aux_e = tmoe.moe_apply(kcfg, p, xt)
    return {"plain": plain.numpy(), "meshed": meshed.numpy(),
            "y_dense": y_d.numpy(), "y_ep": y_e.numpy(),
            "aux_dense": aux_d.numpy(), "aux_ep": aux_e.numpy(),
            "ep_all_reduces": np.int64(tmoe.moe_apply.all_reduces - calls)}


# ------------------------------------------------------------- the cases

def _toks(cfg, B, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


@pytest.mark.parametrize("shape,sub,kv", [("2x2", (1, 4), None),
                                          ("1x2", None, 1),
                                          ("2x2", None, None)],
                         ids=["1x4-kv2", "1x2-kv1", "2x2-kv2"])
def test_gqa_decode_equals_the_single_device_reference(groups, shape, sub,
                                                       kv):
    changes = {} if kv is None else {"num_kv_heads": kv}
    jcfg, jm, jp, ref = _jref("smollm-135m", **changes)
    B, S, T, L = 2, 20, 4, 24
    toks = _toks(jcfg, B, S + T)
    job = groups[shape].submit("rank_decode", arch="smollm-135m", ref=ref,
                               toks=toks, S=S, T=T, L=L, sub=sub,
                               changes=changes)
    want, wcache = _ref_decode(jm, jp, toks, S, T, L)
    outs = job()
    d, m = sub or SHAPES[shape]
    Hkv = kv or jcfg.num_kv_heads
    seq = Hkv % m != 0
    like = jax_tree_numpy(wcache)
    cache = bridge.dense_cache_from_reference(_tcfg("smollm-135m",
                                                    **changes), like)
    for o in outs:
        np.testing.assert_allclose(o["logits"], want, **DECODE_TOL)
        for i, layer in enumerate(cache):
            for n, t in layer.items():
                np.testing.assert_allclose(o[f"cache{i}_{n}"], t.numpy(),
                                           **CACHE_TOL)
        assert int(o["calls"]) == (T * jcfg.num_layers if seq else 0)
        assert int(o["all_reduces"]) == 3 * int(o["calls"])
        full = sum(t.numel() * 4 for layer in cache for t in layer.values())
        # the model axis splits every cache: its slots where it does not
        # divide the kv heads, else the kv heads (the reference's rules)
        assert int(o["local_bytes"]) * m * d == full


def jax_tree_numpy(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("pos,window,sub", [(5, None, (1, 4)),
                                            (17, None, (1, 4)),
                                            (23, None, (1, 4)),
                                            (40, 24, (1, 4)),
                                            (9, None, None)],
                         ids=["rank0", "rank2", "last", "ring", "1x2"])
def test_seq_sharded_decode_equals_the_reference_inner(groups, pos, window,
                                                       sub):
    import jax
    from functools import partial
    from repro.models.decode_sharded import _inner
    rng = np.random.default_rng(pos)
    B, S, Hkv, G, D = 2, 24, 2, 3, 16
    n = (sub or (1, 2))[1]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    kc, vc = f(B, S, Hkv, D), f(B, S, Hkv, D)
    kn, vn, q = f(B, 1, Hkv, D), f(B, 1, Hkv, D), f(B, 1, Hkv * G, D)
    slot = (pos % S) if window else min(pos, S - 1)
    valid = min(pos + 1, S)
    chunks = lambda a: np.stack(np.split(a, n, axis=1))
    job = groups["2x2" if sub else "1x2"].submit(
        "rank_inner", kc=kc, vc=vc, kn=kn, vn=vn, q=q, pos=pos,
        window=window, scale=D ** -0.5, sub=sub)
    want_k, want_v, want_o = jax.vmap(
        partial(_inner, scale=D ** -0.5, model_axis="model"),
        in_axes=(0, 0, None, None, None, None, None), axis_name="model")(
        chunks(kc), chunks(vc), kn, vn, q, np.int32(slot), np.int32(valid))
    outs = job()
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["k"], np.asarray(want_k[r]), rtol=0,
                                   atol=0)
        np.testing.assert_allclose(o["v"], np.asarray(want_v[r]), rtol=0,
                                   atol=0)
        np.testing.assert_allclose(o["o"], np.asarray(want_o[r]),
                                   rtol=1e-6, atol=1e-6)
        assert int(o["all_reduces"]) == 3


def test_mla_latent_decode_equals_the_single_device_reference(groups):
    changes = {"capacity_factor": 8.0}
    jcfg, jm, jp, ref = _jref("deepseek-v2-lite-16b", **changes)
    B, S, T, L = 2, 20, 4, 24
    toks = _toks(jcfg, B, S + T)
    job = groups["1x2"].submit(
        "rank_decode", arch="deepseek-v2-lite-16b", ref=ref, toks=toks, S=S,
        T=T, L=L, changes=changes)
    want, wcache = _ref_decode(jm, jp, toks, S, T, L)
    (o0, o1) = job()
    cache = bridge.dense_cache_from_reference(
        _tcfg("deepseek-v2-lite-16b", **changes), jax_tree_numpy(wcache))
    for o in (o0, o1):
        np.testing.assert_allclose(o["logits"], want, **DECODE_TOL)
        for i, layer in enumerate(cache):
            np.testing.assert_allclose(o[f"cache{i}_ckr"],
                                       layer["ckr"].numpy(), **CACHE_TOL)
        assert int(o["calls"]) == T * jcfg.num_layers
        full = sum(t.numel() * 4 for layer in cache for t in layer.values())
        assert int(o["local_bytes"]) * 2 == full


def _moe_inputs(seed=0, B=4, S=32, skew=0.0):
    """kimi ``.reduced()``'s first MoE layer and tokens x (B, S, d); with
    ``skew`` the tokens lean toward expert 0's router column, so that its
    load passes the capacity and tokens are dropped."""
    cfg, _, _, ref = _jref("kimi-k2-1t-a32b", seed=seed)
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()})
         for k, v in ref["blocks"]["slot0"]["moe"].items()}
    x = np.random.default_rng(seed + 5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    u = p["router"][:, 0]
    x += skew * (u / np.linalg.norm(u) * cfg.d_model ** 0.5)
    return cfg, p, x


@pytest.mark.parametrize("shape", ["2x2", "1x2"])
def test_expert_parallel_moe_with_drops_equals_the_reference_local(groups,
                                                                   shape):
    import jax
    import jax.numpy as jnp
    from functools import partial
    from repro.models import moe as jmoe
    from repro.models.layers import rms_norm, swiglu_apply
    cfg, p, x = _moe_inputs(skew=0.5)
    d, m = SHAPES[shape]
    job = groups[shape].submit("rank_moe", arch="kimi-k2-1t-a32b", p=p, x=x,
                               cf=cfg.capacity_factor)
    B, S, dm = x.shape
    h = rms_norm(jnp.asarray(x), p["ln"])
    x2 = h.reshape(B * S, dm)
    T_loc = B * S // d
    E, k = cfg.num_experts, cfg.top_k
    E_loc = E // m
    C = max(4, int(np.ceil(T_loc * k / E * cfg.capacity_factor)))
    fn = partial(jmoe._moe_local, k=k, E=E, E_loc=E_loc, C=C,
                 model_axis="model",
                 batch_axes=("data",) if d > 1 else ())
    ex = lambda a: jnp.asarray(a).reshape((m, E_loc) + a.shape[1:])
    inner = jax.vmap(fn, in_axes=(None, 0, 0, 0, None), axis_name="model")
    outer = jax.vmap(inner, in_axes=(None, None, None, None, 0),
                     axis_name="data")
    inner, outer = jax.jit(inner), jax.jit(outer)
    if d == 1:
        y, aux = inner(p["router"], ex(p["we_gate"]), ex(p["we_up"]),
                       ex(p["we_down"]), x2)
        y, aux = y[None], aux[None]
    else:
        y, aux = outer(p["router"], ex(p["we_gate"]), ex(p["we_up"]),
                       ex(p["we_down"]), x2.reshape(d, T_loc, dm))
    shared = np.asarray(swiglu_apply(p["shared"], h)).reshape(d, T_loc, dm)
    dense, _ = jmoe._moe_dense(p, x2, k, E)
    for r, o in enumerate(job()):
        di, mi = divmod(r, m)
        want = np.asarray(y[di, mi]) + shared[di]
        # fp32, the expert matmuls summing in another order than XLA's
        np.testing.assert_allclose(o["y"].reshape(T_loc, dm), want,
                                   rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        np.testing.assert_allclose(o["aux"], np.asarray(aux[di, mi]),
                                   rtol=1e-6, atol=1e-6)
    # the drops are real: the dense oracle is far from this
    assert np.abs(np.asarray(y)[:, 0].reshape(B * S, dm) -
                  np.asarray(dense)).max() > 1e-2


@pytest.mark.parametrize("shape", ["2x2", "1x2"])
def test_expert_parallel_moe_without_drops_equals_the_dense_reference(
        groups, shape):
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    cfg, p, x = _moe_inputs(seed=3)
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    y, aux = jmoe.moe_apply(cfg, jax_tree_numpy(p), jnp.asarray(x))
    for o in groups[shape].run("rank_moe", arch="kimi-k2-1t-a32b", p=p,
                               x=x, cf=8.0):
        np.testing.assert_allclose(o["y_full"], np.asarray(y), rtol=3e-4,
                                   atol=3e-4)
        np.testing.assert_allclose(o["aux"], float(aux), rtol=1e-3)


@pytest.mark.parametrize("n,E,seed", [(64, 4, 0), (300, 8, 1),
                                      (1, 3, 2), (257, 64, 3)])
def test_rank_within_expert_is_the_reference(n, E, seed):
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    ids = np.random.default_rng(seed).integers(0, E, n).astype(np.int32)
    want = np.asarray(jmoe._rank_within_expert(jnp.asarray(ids)))
    got = tmoe._rank_within_expert(torch.from_numpy(ids)).numpy()
    assert np.array_equal(got, want)


def test_train_step_gradients_at_2x2_equal_the_reference(groups):
    import jax
    import jax.numpy as jnp
    from repro.models.steps import loss_fn
    changes = {"capacity_factor": 8.0}
    jcfg, jm, jp, ref = _jref("kimi-k2-1t-a32b", **changes)
    toks = _toks(jcfg, 4, 16, seed=7)
    batch = {"tokens": toks, "labels": toks}
    job = groups["2x2"].submit("rank_grads", arch="kimi-k2-1t-a32b",
                               ref=ref, batch=batch, changes=changes)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(jm, p, {k: jnp.asarray(v)
                                  for k, v in batch.items()}),
        has_aux=True))(jp)
    tcfg = _tcfg("kimi-k2-1t-a32b", **changes)
    want = tree_leaves(bridge.from_reference(tcfg,
                                             jax_tree_numpy(grads)))
    for o in job():
        np.testing.assert_allclose(o["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(o["aux"], float(parts["aux"]),
                                   rtol=1e-5)
        assert len(want) == len([k for k in o if k.startswith("g")])
        for i, w in enumerate(want):
            w = w.numpy()
            tol = 1e-4 * float(np.abs(w).max()) + 1e-7
            np.testing.assert_allclose(o[f"g{i}"], w, rtol=0, atol=tol,
                                       err_msg=f"leaf {i}")


LAUNCH = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
          "--log-every", "1", "--batch", "4", "--seq", "32"]
# mesh against no mesh: the data-parallel gradient sums two half-batch
# gradients (summation order only, ~1e-7 relative); AdamW at its eps of
# 1e-8 turns that noise on eps-sized gradient elements into updates
# that differ by up to a step of lr on them from step 2 on
LAUNCH_TOL = dict(rtol=2e-5, atol=0)


def test_train_launcher_with_a_mesh_equals_one_process(groups, tmp_path):
    one = tlaunch.main(LAUNCH + ["--steps", "3"])
    loss = np.array([h["loss"] for h in one])
    gnorm = np.array([h["grad_norm"] for h in one])
    # spawned by the launcher itself
    two = tlaunch.main(LAUNCH + ["--steps", "3", "--mesh", "2x1"])
    np.testing.assert_allclose([h["loss"] for h in two], loss, **LAUNCH_TOL)
    np.testing.assert_allclose([h["grad_norm"] for h in two], gnorm,
                               **LAUNCH_TOL)
    # no mesh for two steps, resumed under the mesh; and the reverse
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    tlaunch.main(LAUNCH + ["--steps", "3", "--ckpt-every", "2",
                           "--ckpt-dir", a])
    import shutil
    shutil.rmtree(os.path.join(a, "step_00000003"))
    for o in groups["1x2"].run("rank_launch", argv=LAUNCH + [
            "--steps", "3", "--mesh", "2x1", "--resume", "--ckpt-dir", a]):
        assert list(o["step"]) == [3]
        np.testing.assert_allclose(o["loss"], loss[2:], **LAUNCH_TOL)
    groups["1x2"].run("rank_launch", argv=LAUNCH + [
        "--steps", "3", "--mesh", "2x1", "--ckpt-every", "2",
        "--ckpt-dir", b])
    shutil.rmtree(os.path.join(b, "step_00000003"))
    back = tlaunch.main(LAUNCH + ["--steps", "3", "--resume",
                                  "--ckpt-dir", b])
    assert [h["step"] for h in back] == [3]
    np.testing.assert_allclose([h["loss"] for h in back], loss[2:],
                               **LAUNCH_TOL)


def test_fp8_cache_under_a_seq_sharding_mesh_decodes_the_gathered_cache(
        groups):
    """The reference skips the seq-sharded decode for a quantized cache and
    decodes the whole (gathered) cache; the port gathers the ranks'
    dequantized slots and runs K3's path, so the logits are the port's
    single-device fp8 decode's (the quantizer is bit-equal on the CPU;
    the gather adds exact zeros) within summation order."""
    _, _, _, ref = _jref("smollm-135m")
    cfg = _tcfg("smollm-135m")
    B, S, T, L = 2, 20, 4, 24
    toks = _toks(cfg, B, S + T, seed=4)
    model = tget_model(cfg)
    params = bridge.from_reference(cfg, ref)
    cache = model.init_cache(B, L, dtype=torch.float8_e4m3fn, device="cpu")
    t = torch.from_numpy(toks)
    lg, cache = model.forward(params, mode="full", cache=cache,
                              tokens=t[:, :S])
    want = [lg[:, -1]]
    for s in range(T):
        lg, cache = model.forward(params, mode="decode", cache=cache,
                                  tokens=t[:, S + s:S + s + 1], pos=S + s)
        want.append(lg[:, 0])
    want = torch.stack(want, 1).numpy()
    for o in groups["2x2"].run("rank_decode", arch="smollm-135m", ref=ref,
                               toks=toks, S=S, T=T, L=L, sub=(1, 4),
                               cache_dtype="float8_e4m3fn"):
        np.testing.assert_allclose(o["logits"], want, rtol=1e-5, atol=1e-5)
        assert int(o["calls"]) == 0          # not the seq-sharded decode
        np.testing.assert_array_equal(o["cache0_k_scale"],
                                      cache[0]["k_scale"].numpy())


def test_one_by_one_mesh_equals_no_mesh(groups):
    _, _, _, ref_s = _jref("smollm-135m")
    toks = _toks(_tcfg("smollm-135m"), 2, 24, seed=9)
    _, kp, x = _moe_inputs(seed=4)
    (o,) = groups["1x1"].run("rank_one_by_one", ref_s=ref_s, toks=toks,
                             kref=kp, x=x)
    assert np.array_equal(o["plain"], o["meshed"])
    np.testing.assert_allclose(o["y_ep"], o["y_dense"], rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(o["aux_ep"], o["aux_dense"], rtol=1e-3)
    assert int(o["ep_all_reduces"]) == 1     # "model" sums once; no "data"


def test_dtensor_views_gather_to_the_global_tensor(groups):
    x = np.arange(4 * 6 * 3, dtype=np.float32).reshape(4, 6, 3)
    for r, o in enumerate(groups["2x2"].run("rank_dtensor", x=x)):
        assert np.array_equal(o["full"], x)
        assert np.array_equal(o["back"], x)
        assert np.array_equal(o["moved"], x)
        # "experts" on dim 1 under the default rules: the model axis
        m = r % 2
        assert np.array_equal(o["moved_local"], x[:, 3 * m:3 * m + 3])
        assert str(o["placements"]) == str(o["want_placements"])
        assert str(o["spec_placements"]) == str(o["want_placements"])


def test_refusals_name_what_they_refuse(groups):
    """The mesh and the experts are refused by name (the reference
    asserts ``E % model_size == 0`` too). A cache of 30 slots on a model
    axis of 4 that divides neither its 2 kv heads nor its slots, and a
    global batch of 3 over 2 data ranks, were refused until P13e; they
    now run as the reference places them: the cache whole on each rank,
    the batch on each data rank."""
    (o, *_) = groups["2x2"].run("rank_refusals")
    assert "a 4x2 mesh needs 8 ranks, the process group has 4" \
        in str(o["mesh"])
    assert str(o["cache"]) == ""
    cfg = _tcfg("smollm-135m")
    assert tuple(o["cache_shape"]) == (2, 30, cfg.num_kv_heads,
                                       cfg.head_dim)
    assert not bool(o["cache_split"])
    assert "6 experts do not split over a model axis of 4" \
        in str(o["experts"])
    assert str(o["batch"]) == ""
    assert np.isfinite(o["batch_loss"])
    with pytest.raises(SystemExit, match="expected dxm"):
        tlaunch.main(LAUNCH + ["--mesh", "2by1"])
