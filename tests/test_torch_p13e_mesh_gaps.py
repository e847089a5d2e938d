"""P13e: every mesh placement the reference runs, on two gloo ranks on
the CPU, where the port refused until now.

One gloo group of two ranks runs for the module (``launch.mesh.
RankGroup``; every case is a job on it), as (data 1, model 2) or (data
2, model 1). The parent, the only process that imports JAX, holds the
ranks' results to the one-process port and to the reference on the same
numpy weights (``bridge.shard_params``), at P13c's tolerances: decode
logits at rtol/atol 3e-4 against the reference (its own tolerance) and
3e-5 against one process (fp32 partial products summed over "model" in
another order); training at the train-step parity tolerances (loss,
ce and aux to 1e-5 relative, every gradient leaf to 1e-4 of its largest
magnitude, the parameters after two AdamW steps to 2e-3 of the rate).
Configs at ``.reduced()`` with the widths changed so that a model axis
of 2 meets each case (``sharding.resolve_spec`` decides each split as
the reference's does; ``test_the_cases_meet_their_placements`` checks
it):

* G1, a cache the model axis does not divide: smollm's 9 q and 3 kv
  heads with 37 slots, and recurrentgemma's ring of 37 (window 37) over
  a 40-token prompt: the cache whole on each rank (a plain dict, the
  reference's replicated axes), every slot written, decoded through K3.
* G2, a global batch of 3 on (data 2, model 1): smollm, deepseek (MoE
  aux loss) and smollm under FSDP; each rank holds the whole batch, and
  loss, ce, aux and gradients are the reference's, not twice them; the
  train launcher takes ``--batch 3 --mesh 2x1``.
* Mid-head splits, computed whole: MLA with 3 heads (wq's columns
  gathered), Mamba-2 with 3 ssm heads over an inner width of 192 (wz
  and wx gathered, K5 at every head), qwen3's 12 q heads on 3 kv heads
  (6 local q heads straddle kv groups: dense caches of 24 slots,
  sequence-sharded, and 25, whole; and the paged pool), and RG-LRU's 3
  gate blocks over 192 channels.
* F4's plain backward: a row that sees one key gives dQ and dK of
  exactly 0.

Before P13e the port refused each case with a ``ValueError``. This
module imports no JAX at its top: the ranks import it.
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
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import RankGroup, make_local_mesh
from repro_torch.models import decode_sharded
from repro_torch.models import steps as tsteps
from repro_torch.models.model import get_model as tget_model
from repro_torch.training import optim as toptim
from test_torch_p13c_placement import _map_shapes, _reference_like

JOB_TIMEOUT = 180.0
DECODE_TOL = dict(rtol=3e-4, atol=3e-4)
PORT_TOL = dict(rtol=3e-5, atol=3e-5)
LR = 1e-2
MIN_SIZE = 256
MOE = {"capacity_factor": 8.0}
B = 2
CASES = {
    "g1-dense": ("smollm-135m", {"num_heads": 9, "num_kv_heads": 3}),
    "g1-ring": ("recurrentgemma-9b", {"attn_window": 37}),
    "mla-mid": ("deepseek-v2-lite-16b", {"num_heads": 3,
                                         "num_kv_heads": 3, **MOE}),
    "ssm-mid": ("mamba2-370m", {"d_model": 96, "ssm_head_dim": 64}),
    "straddle": ("qwen3-4b", {"num_heads": 12, "num_kv_heads": 3}),
    "straddle-whole": ("qwen3-4b", {"num_heads": 12, "num_kv_heads": 3}),
    "rglru-mid": ("recurrentgemma-9b", {"lru_width": 192,
                                        "lru_diag_blocks": 3}),
    "smollm": ("smollm-135m", {}),
    "deepseek": ("deepseek-v2-lite-16b", MOE),
}
# (prompt, decode steps, max_len) of each decode case
DECODE = {"g1-dense": (20, 4, 37), "g1-ring": (40, 4, 48),
          "mla-mid": (20, 4, 24), "ssm-mid": (20, 4, 24),
          "straddle": (20, 4, 24), "straddle-whole": (20, 4, 25),
          "rglru-mid": (20, 4, 24)}
PAGE, PAGED_S, PAGED_T = 4, 16, 4


def _tcfg(case):
    name, changes = CASES[case]
    return dataclasses.replace(tget_config(name).reduced(), **changes)


# ------------------------------------------------------------ the group

@functools.lru_cache(maxsize=None)
def _mesh(shape):
    """(data, model) over both ranks (made once a rank, in the same
    order on all)."""
    return make_local_mesh(*(int(n) for n in shape.split("x")), "cpu")


def _serve(jobs, done, outdir):
    rank = dist.get_rank()
    torch.set_num_threads(1)
    for shape in ("1x2", "2x1"):
        _mesh(shape)
    while True:
        job = jobs[rank].get()
        if job is None:
            return None
        jid, name, shape, kw = job
        try:
            out = globals()[name](_mesh(shape), **kw)
            np.savez(os.path.join(outdir, f"{jid}_{rank}.npz"), **out)
            done.put((jid, rank, None))
        except Exception:
            done.put((jid, rank, traceback.format_exc()))


class Group:
    world = 2

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
    g = Group(tmp_path_factory.mktemp("p13e"))
    yield g
    g.close()


# ------------------------------------------------------- weights, inputs

@functools.lru_cache(maxsize=None)
def _numpy_ref(case):
    """The reference's weights as numpy, drawn without JAX into the
    port's mirror of the reference's tree (``jax.tree.leaves`` order):
    matrices at fan_in^-1/2, vectors at 0.1 (norm weights not zero)."""
    cfg = _tcfg(case)
    rng = np.random.default_rng(0)

    def draw(shape):
        scale = shape[-2] ** -0.5 if len(shape) >= 2 else 0.1
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return _map_shapes(_reference_like(cfg, tget_model(cfg)), draw)


@functools.lru_cache(maxsize=None)
def _jref(case):
    """The reference's model and its params (the same numpy draws)."""
    import jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.models.model import get_model
    name, changes = CASES[case]
    model = get_model(dataclasses.replace(get_config(name).reduced(),
                                          **changes))
    tree = _numpy_ref(case)

    def to_jax(t):
        return ({k: to_jax(v) for k, v in t.items()} if isinstance(t, dict)
                else jnp.asarray(t))
    return model, to_jax(tree)


def _toks(cfg, rows, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (rows, n)).astype(np.int32)


def _batches(cfg):
    """Two global batches of 3 rows (the data axis of 2 divides none)."""
    return [{"tokens": t, "labels": t}
            for t in (_toks(cfg, 3, 16, seed=5 + i) for i in range(2))]


def _ocfg(mod):
    return mod.AdamWConfig(lr=LR, eps=1e-4, warmup_steps=0)


# ----------------------------------------------------------- decode runs

def _port_decode(cfg, params, toks, S, T, L):
    """A prefill of S tokens and T decode steps on an fp32 dense cache of
    ``L`` slots: logits (rows, T + 1, V), and whether each layer's cache
    came out split over "model"."""
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
    split = [isinstance(c, decode_sharded.SeqSplitCache) for c in cache]
    return torch.stack(out, 1), split, cache


def _ref_decode(case, toks, S, T, L):
    import jax
    import jax.numpy as jnp
    model, params = _jref(case)
    cache = model.init_cache(toks.shape[0], L, dtype=jnp.float32)
    lg, cache = jax.jit(lambda p, c, t: model.forward(
        p, mode="full", cache=c, tokens=t)[:2])(params, cache,
                                                jnp.asarray(toks[:, :S]))
    out = [np.asarray(lg[:, -1])]
    step = jax.jit(lambda p, c, t, pos: model.forward(
        p, mode="decode", tokens=t, cache=c, pos=pos)[:2])
    for t in range(T):
        lg, cache = step(params, cache, jnp.asarray(toks[:, S + t:S + t + 1]),
                         jnp.int32(S + t))
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, 1)


def _paged(cfg, params, toks):
    """A prefill of PAGED_S tokens a row as one chunk run a row into a
    paged pool (pages of PAGE, page 0 the scratch page) and PAGED_T paged
    decode steps: logits (B, PAGED_T + 1, V)."""
    model = tget_model(cfg)
    n = (PAGED_S + PAGED_T) // PAGE          # pages a row
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    shape = sharding.local_shape((1 + B * n, PAGE, Hkv, D),
                                 (None, None, "kv_heads", None))
    pool = [{"k_pages": torch.zeros(shape), "v_pages": torch.zeros(shape)}
            for _ in range(cfg.num_layers)]
    table = torch.arange(1, 1 + B * n, dtype=torch.int32).reshape(B, n)
    lg, pool = model.forward(
        params, mode="chunk", tokens=toks[:, :PAGED_S], cache=pool,
        pos=torch.zeros(B, dtype=torch.int32), block_table=table,
        dst_page=table[:, :PAGED_S // PAGE])
    out = [lg[:, -1]]
    for t in range(PAGED_T):
        lg, pool = model.forward(
            params, mode="decode", tokens=toks[:, PAGED_S + t:PAGED_S + t + 1],
            cache=pool, pos=torch.full((B,), PAGED_S + t, dtype=torch.int32),
            block_table=table)
        out.append(lg[:, 0])
    return torch.stack(out, 1)


# ------------------------------------------------------------- rank jobs

def rank_decode(mesh, case, paged=False):
    cfg = _tcfg(case)
    toks = torch.from_numpy(_toks(cfg, B, 48))
    c0 = decode_sharded.seq_sharded_decode.calls
    with sharding.axis_rules(mesh):
        params = bridge.shard_params(cfg, _numpy_ref(case), mesh)
        if paged:
            lg, split, shapes = _paged(cfg, params, toks), [], []
        else:
            lg, split, cache = _port_decode(cfg, params, toks, *DECODE[case])
            shapes = [tuple(c["k"].shape) if "k" in c else (0,) * 4
                      for c in cache]
    return {"logits": lg.numpy(), "split": np.array(split, dtype=bool),
            "shapes": np.array(shapes, dtype=np.int64),
            "seq_calls": np.int64(decode_sharded.seq_sharded_decode.calls
                                  - c0)}


def _grads_full(model, grads, axes):
    return [sharding.gather_global(g, ax, s.shape).numpy()
            for g, ax, s in zip(toptim.tree_leaves(grads),
                                _axes_leaves(axes),
                                toptim.tree_leaves(model.abstract()))]


def _axes_leaves(axes):
    if isinstance(axes, dict):
        return [a for k in sorted(axes) for a in _axes_leaves(axes[k])]
    if isinstance(axes, list):
        return [a for v in axes for a in _axes_leaves(v)]
    return [axes]


def _train_run(cfg, params, fsdp=False):
    """Step 1's (loss, ce, aux) and gradients, then two AdamW steps:
    (parts, grads, metrics (2, 2), params)."""
    model = tget_model(cfg)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches(cfg)]
    loss, parts, grads = tsteps.value_and_grad(model, params, batches[0])
    ocfg = _ocfg(toptim)
    state = tsteps.init_opt_state(model, ocfg, params)
    step = tsteps.make_train_step(model, ocfg, remat=False)
    metrics = []
    for b in batches:
        params, state, m = step(params, state, b)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    return ([float(loss), float(parts["ce"]), float(parts["aux"])], grads,
            np.array(metrics), params)


def rank_train(mesh, case, fsdp=False):
    cfg = _tcfg(case)
    model = tget_model(cfg)
    with sharding.axis_rules(mesh, fsdp=fsdp, min_size=MIN_SIZE):
        params = bridge.shard_params(cfg, _numpy_ref(case), mesh)
        parts, grads, metrics, params = _train_run(cfg, params)
        axes = sharding.placed_axes(model)
        out = {"parts": np.array(parts), "metrics": metrics,
               "fsdp_split": np.int64(sum(
                   sharding.fsdp_split(a) for a in _axes_leaves(axes)))}
        for i, g in enumerate(_grads_full(model, grads, axes)):
            out[f"g{i}"] = g
        for i, p in enumerate(_grads_full(model, params, axes)):
            out[f"p{i}"] = p
    return out


def rank_launch(mesh, argv):
    hist = tlaunch.main(argv)
    return {"loss": np.array([h["loss"] for h in hist]),
            "gnorm": np.array([h["grad_norm"] for h in hist])}


# ------------------------------------------------------------- the cases

class _Stand:
    """A mesh stand-in for the reference's resolution (its tests' own)."""

    def __init__(self, **shape):
        self.shape = shape


def test_the_cases_meet_their_placements():
    """Each case's config meets its placement on a model axis of 2 under
    the reference's own ``resolve_spec``: the columns split mid-head, the
    gate blocks or kv heads undivided, the slots undivided, a batch of 3
    unsplit over a data axis of 2."""
    from repro.models import decode_sharded as jdec
    from repro.sharding import axis_rules, resolve_spec
    tp = _Stand(data=1, model=2)

    def split(shape, axes, mesh=tp):
        return any(e is not None for e in resolve_spec(shape, axes, mesh))

    c = _tcfg("mla-mid")
    width = c.nope_head_dim + c.rope_head_dim
    assert split((c.d_model, c.num_heads * width), (None, "heads"))
    assert c.num_heads % 2
    c = _tcfg("ssm-mid")
    assert c.ssm_heads == 3
    assert split((c.d_model, c.ssm_inner), (None, "ssm_heads"))
    assert not split((c.d_model, c.ssm_heads), (None, "ssm_heads"))
    c = _tcfg("straddle")
    assert (c.num_heads // c.num_kv_heads) % (c.num_heads // 2)
    assert split((c.d_model, c.num_heads * c.head_dim), (None, "heads"))
    assert not split((1, c.num_kv_heads), (None, "kv_heads"))
    c = _tcfg("rglru-mid")
    bs = c.lru_width // c.lru_diag_blocks
    assert split((c.d_model, c.lru_width), (None, "lru"))
    assert not split((c.lru_diag_blocks, bs, bs), ("lru", None, None))
    with axis_rules(tp):
        assert not jdec.use_seq_sharded(3, 37)     # g1-dense
        assert not jdec.use_seq_sharded(1, 37)     # g1-ring
        assert not jdec.use_seq_sharded(3, 25)     # straddle-whole
        assert jdec.use_seq_sharded(3, 24)         # straddle: split
        assert jdec.use_seq_sharded(0, 24)         # mla-mid: split
    assert not split((3, 16), ("batch", None), _Stand(data=2, model=1))


def _hold_decode(case, outs, want_split):
    S, T, L = DECODE[case]
    cfg = _tcfg(case)
    toks = _toks(cfg, B, 48)
    want = _ref_decode(case, toks, S, T, L)
    one, _, _ = _port_decode(cfg, bridge.from_reference(cfg,
                                                        _numpy_ref(case)),
                             torch.from_numpy(toks), S, T, L)
    np.testing.assert_allclose(one.numpy(), want, **DECODE_TOL)
    for o in outs:
        np.testing.assert_allclose(o["logits"], one.numpy(), **PORT_TOL)
        np.testing.assert_allclose(o["logits"], want, **DECODE_TOL)
        assert list(o["split"]) == want_split(cfg), case
    return cfg, outs


def _attn_layers(cfg, model):
    return [bt in ("attn", "mla") for bt in model.block_types]


@pytest.mark.parametrize("case", ["g1-dense", "g1-ring"])
def test_g1_a_cache_the_axis_does_not_divide_is_whole(group, case):
    """37 slots on a model axis of 2 (max_len, or a ring's W): every
    rank keeps every slot (and, its kv heads undivided, every kv head),
    the prefill writes them all and decode runs K3 on it, no layer
    through the sequence-sharded region."""
    cfg = _tcfg(case)
    model = tget_model(cfg)
    outs = group.submit("rank_decode", "1x2", case=case)()
    _hold_decode(case, outs, lambda c: [False] * c.num_layers)
    _, _, L = DECODE[case]
    W = min(cfg.attn_window or L, L)
    for o in outs:
        assert int(o["seq_calls"]) == 0
        for shape, attn in zip(o["shapes"], _attn_layers(cfg, model)):
            if attn:
                assert tuple(shape) == (B, W, cfg.num_kv_heads,
                                        cfg.head_dim)


@pytest.mark.parametrize("case", ["mla-mid", "ssm-mid", "straddle",
                                  "straddle-whole", "rglru-mid"])
def test_mid_head_splits_are_computed_whole(group, case):
    """A split the rules place mid-head (or gate blocks the axis does
    not divide, or local q heads that straddle kv groups) computed with
    its columns gathered over "model": the ranks hold one process and
    the reference. Caches of 24 slots (mla-mid's latent cache, the
    straddling heads' K/V, rglru-mid's ring) are sequence-sharded as
    before, so the straddling heads' prefill reads each local q head's kv
    head through K4; with 25 slots (straddle-whole) the cache stays whole
    and decode reads them from the whole cache through K3 too."""
    cfg = _tcfg(case)
    model = tget_model(cfg)
    outs = group.submit("rank_decode", "1x2", case=case)()
    seq = case in ("mla-mid", "straddle", "rglru-mid")
    _hold_decode(case, outs, lambda c: [seq and a for a in
                                        _attn_layers(c, model)])
    for o in outs:
        n_attn = sum(_attn_layers(cfg, model))
        assert int(o["seq_calls"]) == (DECODE[case][1] * n_attn if seq
                                       else 0)


def test_paged_pool_under_q_heads_split_over_whole_kv_heads(group):
    """qwen3 at 12 q on 3 kv heads, 1x2: the pool holds every kv head,
    and chunk prefill and paged decode run K2 and K1 at every head on q
    gathered over "model", keeping the rank's 6 heads: the ranks hold
    one process, which holds the reference's dense decode."""
    cfg = _tcfg("straddle")
    toks = _toks(cfg, B, 48)
    job = group.submit("rank_decode", "1x2", case="straddle", paged=True)
    want = _ref_decode("straddle", toks, PAGED_S, PAGED_T,
                       PAGED_S + PAGED_T)
    one = _paged(cfg, bridge.from_reference(cfg, _numpy_ref("straddle")),
                 torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(one, want, **DECODE_TOL)
    for o in job():
        np.testing.assert_allclose(o["logits"], one, **PORT_TOL)
        np.testing.assert_allclose(o["logits"], want, **DECODE_TOL)


@functools.lru_cache(maxsize=None)
def _ref_train(case):
    """The reference on the global batch: step 1's (loss, ce, aux) and
    gradients, and two steps' metrics and params (numpy)."""
    import jax
    import jax.numpy as jnp
    from repro.models.steps import loss_fn, make_train_step
    from repro.training import optim as joptim
    model, params = _jref(case)
    bs = [{k: jnp.asarray(v) for k, v in b.items()}
          for b in _batches(_tcfg(case))]
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(model, p, bs[0]), has_aux=True))(params)
    ocfg = _ocfg(joptim)
    state = joptim.init_state(ocfg, params)
    step = jax.jit(make_train_step(model, ocfg, remat=False))
    metrics = []
    for b in bs:
        params, state, m = step(params, state, b)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    np_tree = functools.partial(jax.tree.map, np.asarray)
    return ([float(loss), float(parts["ce"]), float(parts["aux"])],
            np_tree(grads), np.array(metrics), np_tree(params))


@pytest.mark.parametrize("case,fsdp", [("smollm", False),
                                       ("deepseek", False),
                                       ("smollm", True)],
                         ids=["smollm", "deepseek-aux", "smollm-fsdp"])
def test_g2_a_batch_the_data_axis_does_not_divide(group, case, fsdp):
    """A global batch of 3 on (data 2, model 1): both ranks hold all 3
    rows. Step 1's loss, ce, aux and every gradient leaf are the
    reference's (a rank that counted its whole-batch loss, or the aux
    term, once per data rank would give them twice), and two AdamW
    steps hold the reference and one process."""
    cfg = _tcfg(case)
    job = group.submit("rank_train", "2x1", case=case, fsdp=fsdp)
    parts, grads, metrics, params = _ref_train(case)
    one = _train_run(cfg, bridge.from_reference(cfg, _numpy_ref(case)))
    want_g = [g.numpy() for g in toptim.tree_leaves(
        bridge.from_reference(cfg, grads))]
    want_p = [p.numpy() for p in toptim.tree_leaves(
        bridge.from_reference(cfg, params))]
    np.testing.assert_allclose(one[0], parts, rtol=1e-5, atol=1e-7)
    for o in job():
        np.testing.assert_allclose(o["parts"], parts, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(o["parts"], one[0], rtol=1e-5, atol=0)
        np.testing.assert_allclose(o["metrics"], metrics, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(o["metrics"], one[2], rtol=1e-5, atol=0)
        for i, w in enumerate(want_g):
            tol = 1e-4 * float(np.abs(w).max()) + 1e-7
            np.testing.assert_allclose(o[f"g{i}"], w, rtol=0, atol=tol,
                                       err_msg=f"gradient leaf {i}")
        for i, w in enumerate(want_p):
            assert float(np.abs(o[f"p{i}"] - w).max()) <= 2e-3 * LR, i
        assert (int(o["fsdp_split"]) > 0) == fsdp
    if case == "deepseek":
        assert parts[2] > 0                  # the aux loss is there


def test_g2_the_launcher_takes_such_a_batch(group):
    """``--batch 3 --mesh 2x1``: each rank trains on the whole batch, and
    the losses and norms are one process's."""
    argv = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
            "--log-every", "1", "--batch", "3", "--seq", "32",
            "--steps", "2"]
    job = group.submit("rank_launch", "2x1", argv=argv + ["--mesh", "2x1"])
    one = tlaunch.main(argv)
    for o in job():
        np.testing.assert_allclose(o["loss"], [h["loss"] for h in one],
                                   rtol=2e-5, atol=0)
        np.testing.assert_allclose(o["gnorm"],
                                   [h["grad_norm"] for h in one],
                                   rtol=2e-5, atol=0)


def test_f4_a_row_that_sees_one_key_has_zero_dq_and_dk():
    """The plain backward's D is sum_j softmax(S)_ij dP_ij: for a window
    of 1 each row sees one key, D is its dP exactly, and dQ and dK are
    exactly 0 (the exact gradient), as K4's backward kernel gives them;
    dV is dO."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, 40, 6, 64, generator=g)
    k, v = (torch.randn(1, 40, 3, 64, generator=g) for _ in range(2))
    do = torch.randn(1, 40, 6, 64, generator=g)
    scale = 64 ** -0.5
    o, lse = tref.flash_attention(q, k, v, scale, True, 1, 0,
                                  return_lse=True)
    dq, dk, dv = tref.flash_attention_bwd(q, k, v, o, lse, do, scale, True,
                                          1, 0)
    assert torch.count_nonzero(dq) == 0 and torch.count_nonzero(dk) == 0
    want_dv = do.reshape(1, 40, 3, 2, 64).sum(3)
    torch.testing.assert_close(dv, want_dv, rtol=1e-6, atol=1e-6)
