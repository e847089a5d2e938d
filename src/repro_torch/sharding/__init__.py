"""Logical-axis sharding rules.

Port of ``repro/sharding/__init__.py``. Models annotate every parameter
and activation dimension with a *logical* axis name ("batch", "heads",
"experts", ...). A rules table maps logical names to physical mesh axes;
resolution drops mesh axes that do not divide the dimension (e.g.
kv_heads=2 on a 16-way model axis -> replicated), so one model definition
serves every mesh.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``launch.mesh.make_local_mesh``: ``("data", "model")``) or, for the
pure resolution logic, any object with a ``.shape`` dict of axis sizes
(the reference's tests use such stand-ins). ``resolve_spec`` returns the
reference's ``PartitionSpec`` as a tuple; ``placements`` turns one into
the DTensor placements of a real mesh (``Shard(i)`` or ``Replicate()``
per mesh dim), and ``named_sharding`` carries both.

The reference is SPMD: ``jit`` partitions global arrays, GSPMD inserts
the collectives its sharding constraints call for, and two regions (the
MoE dispatch and the sequence-sharded decode) are written per device
under ``shard_map``. The port runs the model on each rank's LOCAL
tensors and writes those collectives out. ``LOCAL_RULES`` is what the
local layout resolves under: the reference's ``DEFAULT_RULES``, so each
rank holds exactly the slice of a weight or a cache leaf the reference
places on its device: heads, kv heads, ff, vocab, ssm_heads and lru
tensor-parallel over "model", experts over "model", the batch over
"pod" and "data", and with FSDP a weight's "fsdp" dim over "pod" and
"data". A dim the mesh axes do not divide stays replicated, as the
rules say. ``local_slice`` takes a global tensor to this rank's shard
under a spec and ``gather_global`` is its inverse (an all-reduce of a
zero-filled global buffer, per mesh dim: gloo on CUDA tensors has no
all-gather). ``shard`` is the identity on a plain local tensor and a
``redistribute`` on a DTensor.

``placed_axes(model)`` gives the logical axes a rank's weights are
placed by, and every consumer (``Model.init``, the bridge, the train
step, the launcher's checkpoints, the dry-run) reads its placement from
it. Without FSDP it is ``Model.axes()``. ``axis_rules(mesh, fsdp=True)``
turns on the reference's ZeRO-3 placement (its dry-run's ``--fsdp``):
``apply_fsdp``'s choice, made on the reference's stacked layout (a layer
of a repeating pattern group decided as its stacked leaf, the "layers"
dim leading). ``fsdp_gather`` gathers a layer's split leaves over the
data axes just before the layer runs (one flat buffer a layer, an
all-reduce of a zero-filled buffer, as ``gather_global``) and, in the
backward, sums their gradients over the same axes and keeps the rank's
slice: the reference's all-gather and reduce-scatter, run as
all-reduces.

The tensor-parallel helpers act over the "model" group and are the
identity without a mesh or with a model axis of one rank, so a
one-process run is unchanged bit for bit: ``model_ranks`` and
``model_rank``, ``model_offset`` (where a rank's slice of a split dim
starts), ``model_sum`` and ``model_gather`` (no gradient), and the
autograd pairs around a tensor-parallel region (``torch.distributed``'s
collectives have no backward): ``column_in`` (identity forward, a sum
over "model" backward: a replicated tensor read by split work),
``row_out`` (a sum forward, identity backward: split partial sums made
whole) and ``gather_out`` (a gather over "model" forward, the rank's
slice of the gradient backward).
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass

import torch

# logical axis -> tuple of candidate physical mesh axes (applied in order)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "ssm_heads": ("model",),
    "lru": ("model",),
    "kv_seq": ("model",),
    "fsdp": ("pod", "data"),
    "seq": (),
    "layers": (),
    "d_model": (),
    "state": (),
    "kv_lora": (),
}

# the rules the port's local layout resolves weights, caches and batches
# under: the reference's ("fsdp", which only ``placed_axes`` names, over
# the data axes)
LOCAL_RULES = DEFAULT_RULES

# the reference's ``apply_fsdp`` default: smaller leaves stay replicated
FSDP_MIN_SIZE = 2 ** 16


class _Ctx:
    mesh = None
    rules: dict = DEFAULT_RULES
    fsdp: int | None = None     # apply_fsdp's min_size while FSDP is on
    batch: int | None = None    # the global batch rows (``global_batch``)


_CTX = _Ctx()


@contextmanager
def axis_rules(mesh, rules: dict | None = None, *, fsdp: bool = False,
               min_size: int = FSDP_MIN_SIZE):
    """Install a mesh + logical rules for ``shard()`` and
    ``named_sharding()`` resolution and for the model's mesh paths.
    ``fsdp`` places weights as the reference's dry-run ``--fsdp`` does
    (``placed_axes``; ``min_size`` is ``apply_fsdp``'s)."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.fsdp)
    _CTX.mesh = mesh
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    _CTX.fsdp = min_size if fsdp else None
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.fsdp = prev


def current_mesh():
    return _CTX.mesh


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a stand-in's ``.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    # a DeviceMesh rebuilds its rank tensor on every ``.mesh``: read it
    # once a mesh (the entry keeps the mesh, so its id is not reused)
    hit = _MESH_SHAPES.get(id(mesh))
    if hit is None or hit[0] is not mesh:
        hit = _MESH_SHAPES[id(mesh)] = (mesh, dict(zip(names,
                                                       mesh.mesh.shape)))
    return dict(hit[1])


_MESH_SHAPES: dict = {}


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: one entry per tensor dim, None
    (replicated), a mesh axis name, or a tuple of names (major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def resolve_spec(shape, logical_axes, mesh=None,
                 rules: dict | None = None) -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec for a given shape,
    dropping mesh axes that don't divide the dim and axes already used."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return P()
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    sizes = mesh_shape(mesh)
    used: set = set()
    spec = []
    for dim, name in zip(shape, logical_axes):
        if name is None:
            spec.append(None)
            continue
        cands = rules.get(name, ())
        chosen = []
        size = 1
        for ax in cands:
            if ax not in sizes or ax in used:
                continue
            ax_size = sizes[ax]
            if dim % (size * ax_size) == 0:
                chosen.append(ax)
                size *= ax_size
        used.update(chosen)
        if not chosen:
            spec.append(None)
        elif len(chosen) == 1:
            spec.append(chosen[0])
        else:
            spec.append(tuple(chosen))
    return P(*spec)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on a DeviceMesh: per mesh dim,
    ``Shard(i)`` for the tensor dim whose entry names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for i, entry in enumerate(spec):
        for ax in _entry_axes(entry):
            out[mesh.mesh_dim_names.index(ax)] = Shard(i)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``);
    ``placements`` for a DeviceMesh."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


def named_sharding(shape, logical_axes, mesh=None) -> NamedSharding:
    mesh = mesh or _CTX.mesh
    return NamedSharding(mesh, resolve_spec(shape, logical_axes, mesh))


def shard(x, *logical_axes):
    """The reference's sharding constraint by logical names: the identity
    on a plain (local) tensor or without a mesh, a ``redistribute`` to
    the resolved placements on a DTensor."""
    from torch.distributed.tensor import DTensor
    if _CTX.mesh is None or not isinstance(x, DTensor):
        return x
    spec = resolve_spec(x.shape, logical_axes)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def _walk(shapes_tree, axes_tree):
    """(shape leaf, axes leaf) pairs of two parallel trees (dicts, lists);
    a shape leaf is anything with ``.shape``, an axes leaf a tuple."""
    if isinstance(shapes_tree, dict):
        for k in sorted(shapes_tree):
            yield from _walk(shapes_tree[k], axes_tree[k])
    elif isinstance(shapes_tree, list):
        for s, a in zip(shapes_tree, axes_tree):
            yield from _walk(s, a)
    else:
        yield shapes_tree, axes_tree


def _rebuild(like, leaves):
    return _build(like, iter(leaves))


def _build(node, it):
    # a module-level recursion: a closure that calls itself is a reference
    # cycle, which would keep ``leaves`` (gathered weights) alive until
    # the garbage collector runs
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, list):
        return [_build(v, it) for v in node]
    return next(it)


def apply_fsdp(shapes_tree, axes_tree, mesh=None, fsdp_axis: str = "data",
               min_size: int = 2 ** 16):
    """ZeRO-3-style weight sharding: for each large parameter that does
    not already use ``fsdp_axis``, shard its largest divisible unsharded
    dim over that axis. Returns a new logical-axes tree where the chosen
    dims map to "fsdp" (rules: "fsdp" -> (fsdp_axis,))."""
    mesh = mesh or _CTX.mesh
    n = 1
    if mesh is not None:
        sizes = mesh_shape(mesh)
        for ax in ("pod", "data"):
            n *= sizes.get(ax, 1)
    out = []
    for s, ax in _walk(shapes_tree, axes_tree):
        ax = tuple(ax)
        shape = tuple(s.shape)
        size = math.prod(shape) if shape else 0
        if n <= 1 or size < min_size or len(shape) < 2:
            out.append(ax)
            continue
        # the largest dim that's currently unsharded and divisible by the
        # fsdp axis
        cands = [(shape[i], i) for i in range(len(shape))
                 if ax[i] is None and shape[i] % n == 0]
        if not cands:
            out.append(ax)
            continue
        _, i = max(cands)
        out.append(ax[:i] + ("fsdp",) + ax[i + 1:])
    return _rebuild(shapes_tree, out)


def tree_shardings(shapes_tree, axes_tree, mesh=None):
    """Map a tree of shaped leaves + a parallel tree of logical-axes
    tuples to NamedShardings."""
    mesh = mesh or _CTX.mesh
    return _rebuild(shapes_tree, [named_sharding(tuple(s.shape), a, mesh)
                                  for s, a in _walk(shapes_tree, axes_tree)])


def _map_axes(tree, fn):
    """``fn`` on every axes tuple (or shaped leaf) of a dict/list tree."""
    if isinstance(tree, dict):
        return {k: _map_axes(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_axes(v, fn) for v in tree]
    return fn(tree)


def fsdp_on() -> bool:
    """Whether the current rules place weights by FSDP over a mesh whose
    data axes have more than one rank."""
    mesh = _CTX.mesh
    if mesh is None or _CTX.fsdp is None:
        return False
    sizes = mesh_shape(mesh)
    return any(sizes[ax] > 1 for ax in _fsdp_axes(mesh))


def placed_axes(model, mesh=None, *, fsdp=None, min_size=None):
    """The logical axes ``model``'s weights are placed by, a tree like
    ``Model.axes()``. Without FSDP (the current rules', unless ``fsdp``
    says) that tree itself. With it, ``apply_fsdp``'s axes decided on
    the reference's layout: a layer of a repeating pattern group (the
    reference stacks the group's ``n`` cycles into one leaf) is decided
    on its stacked shape ``(n,) + shape`` with axes ``("layers",) +
    axes``, whose leading entry is then dropped; the other leaves as
    they are. A dim named "fsdp" resolves over ("pod", "data"). The
    tree is made once a model and mesh shape: do not change it."""
    mesh = mesh or _CTX.mesh
    if fsdp is None:
        fsdp = _CTX.fsdp is not None
    if min_size is None:
        min_size = _CTX.fsdp or FSDP_MIN_SIZE
    if mesh is None or not fsdp:
        return model.axes()
    key = (tuple(sorted(mesh_shape(mesh).items())), min_size)
    made = model.__dict__.setdefault("_placed_axes", {})
    if key in made:
        return made[key]
    shapes, axes = model.abstract(), model.axes()
    spans = model.layer_spans()
    n = sum(1 for _, _, grouped in spans if grouped)
    grouped = {i for lo, hi, g in spans if g for i in range(lo, hi)}
    out = apply_fsdp({k: v for k, v in shapes.items() if k != "layers"},
                     {k: v for k, v in axes.items() if k != "layers"},
                     mesh, min_size=min_size)
    out["layers"] = []
    for i, (s, a) in enumerate(zip(shapes["layers"], axes["layers"])):
        if i in grouped:
            stacked = apply_fsdp(
                _map_axes(s, lambda t: torch.empty((n,) + tuple(t.shape),
                                                   device="meta")),
                _map_axes(a, lambda ax: ("layers",) + tuple(ax)), mesh,
                min_size=min_size)
            out["layers"].append(_map_axes(stacked, lambda ax: ax[1:]))
        else:
            out["layers"].append(apply_fsdp(s, a, mesh, min_size=min_size))
    made[key] = out
    return out


# ------------------------------------------------- local shards on a mesh

def _shard_index(mesh, axes) -> tuple[int, int]:
    """(this rank's index, the shard count) along mesh ``axes``, major
    first."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = mesh_shape(mesh)
    idx, n = 0, 1
    for ax in axes:
        idx = idx * sizes[ax] + coord[ax]
        n *= sizes[ax]
    return idx, n


def _fsdp_axes(mesh) -> tuple:
    """The mesh axes a dim named "fsdp" splits over (pod before data)."""
    sizes = mesh_shape(mesh)
    return tuple(ax for ax in DEFAULT_RULES["fsdp"] if ax in sizes)


def fsdp_groups(mesh=None) -> list:
    """The process groups of the data axes FSDP splits over that have
    more than one rank: a gather or a sum over them is an all-reduce
    over each in turn."""
    mesh = mesh or _CTX.mesh
    sizes = mesh_shape(mesh)
    return [mesh.get_group(ax) for ax in _fsdp_axes(mesh) if sizes[ax] > 1]


def batch_groups(mesh=None) -> list:
    """The process groups of the mesh axes the batch splits over
    (``LOCAL_RULES["batch"]``: "pod", then "data") that have more than one
    rank: a SUM over the batch is an all-reduce over each in turn."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return []
    sizes = mesh_shape(mesh)
    return [mesh.get_group(ax) for ax in LOCAL_RULES["batch"]
            if sizes.get(ax, 1) > 1]


@contextmanager
def global_batch(rows: int):
    """Run the model on this rank's share of a global batch of ``rows``
    rows, placed as ``resolve_spec`` places "batch": split over the data
    axes that divide it, whole on the ranks of those that do not (the
    reference replicates such a batch). ``batch_split_axes`` reads it."""
    prev = _CTX.batch
    _CTX.batch = rows
    try:
        yield
    finally:
        _CTX.batch = prev


def batch_split_axes(mesh=None) -> tuple:
    """The mesh axes of more than one rank that split the batch the model
    runs on: ``resolve_spec``'s for the rows of ``global_batch``, or,
    outside it, every batch axis of more than one rank (the caller holds
    its rows of a batch the data axes divide)."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return ()
    sizes = mesh_shape(mesh)
    if _CTX.batch is None:
        axes = LOCAL_RULES["batch"]
    else:
        axes = _entry_axes(resolve_spec((_CTX.batch,), ("batch",), mesh,
                                        LOCAL_RULES)[0])
    return tuple(ax for ax in axes if sizes.get(ax, 1) > 1)


def batch_ranks(mesh=None) -> int:
    """How many ways the mesh splits the batch (its batch axes' sizes
    multiplied)."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return 1
    sizes = mesh_shape(mesh)
    return math.prod(sizes.get(ax, 1) for ax in LOCAL_RULES["batch"])


def local_slice(x, logical_axes, mesh=None, rules: dict | None = None):
    """This rank's shard of the global tensor ``x`` under the spec
    ``logical_axes`` resolve to (``LOCAL_RULES`` by default): a copy of
    its own, so the global tensor's memory can be freed."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return x
    spec = resolve_spec(tuple(x.shape), logical_axes, mesh,
                        rules or LOCAL_RULES)
    out = x
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            i, n = _shard_index(mesh, axes)
            step = x.shape[dim] // n
            out = out.narrow(dim, i * step, step)
    return out.clone() if out is not x else x


def local_shape(shape, logical_axes, mesh=None, rules: dict | None = None):
    """The shape of this rank's shard of a global ``shape``."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return tuple(shape)
    sizes = mesh_shape(mesh)
    spec = resolve_spec(tuple(shape), logical_axes, mesh,
                        rules or LOCAL_RULES)
    return tuple(d // math.prod(sizes[a] for a in _entry_axes(e))
                 for d, e in zip(shape, spec))


def is_sharded(shape, logical_axes, mesh=None, rules: dict | None = None):
    """Whether a tensor of ``shape`` is split across ranks under the
    spec (over a mesh axis of more than one rank)."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return False
    sizes = mesh_shape(mesh)
    return any(math.prod(sizes[a] for a in _entry_axes(e)) > 1
               for e in resolve_spec(tuple(shape), logical_axes, mesh,
                                     rules or LOCAL_RULES))


def gather_global(x, logical_axes, global_shape, mesh=None,
                  rules: dict | None = None):
    """Invert ``local_slice``: the global tensor on every rank, from each
    rank's shard ``x``. Per mesh dim that splits it (of more than one
    rank), an all-reduce SUM of a zero-filled global buffer holding this
    rank's shard in its place (gloo on CUDA tensors offers only
    all-reduce and broadcast). The sizes depend only on the shapes."""
    import torch.distributed as dist
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return x
    spec = resolve_spec(tuple(global_shape), logical_axes, mesh,
                        rules or LOCAL_RULES)
    if all(e is None for e in spec):
        return x
    out = torch.zeros(tuple(global_shape), dtype=x.dtype, device=x.device)
    view = out
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            i, n = _shard_index(mesh, axes)
            step = global_shape[dim] // n
            view = view.narrow(dim, i * step, step)
    view.copy_(x)
    sizes = mesh_shape(mesh)
    for ax in (ax for e in spec for ax in _entry_axes(e)):
        if sizes[ax] > 1:
            dist.all_reduce(out, group=mesh.get_group(ax))
    return out


def to_dtensor(x, logical_axes, global_shape, mesh=None):
    """A DTensor view of this rank's local shard ``x`` (for checkpoints
    and tests; no kernel ever sees one)."""
    from torch.distributed.tensor import DTensor
    mesh = mesh or _CTX.mesh
    spec = resolve_spec(tuple(global_shape), logical_axes, mesh, LOCAL_RULES)
    return DTensor.from_local(x, mesh, placements(spec, mesh),
                              shape=torch.Size(global_shape),
                              stride=torch.empty(global_shape,
                                                 device="meta").stride())


# ------------------------------------------- tensor parallel over "model"

def model_ranks(mesh=None) -> int:
    """The size of the current mesh's "model" axis (1 without a mesh)."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return 1
    return mesh_shape(mesh).get("model", 1)


def model_rank(mesh=None) -> int:
    """This rank's index along "model" (0 without a mesh)."""
    mesh = mesh or _CTX.mesh
    if model_ranks(mesh) == 1:
        return 0
    return mesh.get_local_rank("model")


def model_offset(local: int, mesh=None) -> int:
    """Where this rank's slice of ``local`` entries starts on a dim split
    over "model" (the split is even, rank-major)."""
    return model_rank(mesh) * local


def _model_group():
    return _CTX.mesh.get_group("model")


def model_sum(x, op=None):
    """An all-reduce of ``x`` over "model" (SUM unless ``op``), in a new
    tensor; ``x`` itself with one model rank. No gradient."""
    import torch.distributed as dist
    if model_ranks() == 1:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=_model_group())
    return x


def axes_mean(x, axes):
    """The mean over the ranks of mesh ``axes`` of ``x`` (each rank's
    mean of an equal share): an all-reduce SUM over each axis in a new
    tensor, divided by their ranks. No gradient."""
    import torch.distributed as dist
    mesh = _CTX.mesh
    x = x.contiguous().clone()
    for ax in axes:
        dist.all_reduce(x, group=mesh.get_group(ax))
    sizes = mesh_shape(mesh)
    return x / math.prod(sizes[ax] for ax in axes)


def model_gather(x, dim):
    """The whole of ``x`` along ``dim`` on every rank, from each rank's
    even slice: an all-reduce of a zero-filled buffer (gloo on CUDA
    tensors has no all-gather). ``x`` itself with one model rank. No
    gradient."""
    n = model_ranks()
    if n == 1:
        return x
    shape = list(x.shape)
    loc = shape[dim]
    shape[dim] = loc * n
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, model_offset(loc), loc).copy_(x)
    return model_sum(out)


class _ColumnIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_sum(g)


class _RowOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return model_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.loc = dim, x.shape[dim]
        return model_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, model_offset(ctx.loc), ctx.loc)
                .contiguous(), None)


def column_in(x):
    """A replicated tensor entering split work (a column-parallel matmul,
    this rank's heads): identity forward; backward, the gradient summed
    over "model", since each rank's split work gives only its share of
    it. ``x`` itself with one model rank."""
    return x if model_ranks() == 1 else _ColumnIn.apply(x)


def row_out(x):
    """Split partial sums made whole (after a row-parallel matmul, a
    masked lookup, a sum of squares): a sum over "model" forward,
    identity backward. ``x`` itself with one model rank."""
    return x if model_ranks() == 1 else _RowOut.apply(x)


def gather_out(x, dim):
    """``model_gather`` with a gradient: backward keeps this rank's slice
    of the (replicated) gradient."""
    return x if model_ranks() == 1 else _GatherOut.apply(x, dim)


# ------------------------------------------------- FSDP over the data axes

class _FsdpGather(torch.autograd.Function):
    """Leaves split over the data axes at ``dims`` -> gathered whole,
    through one flat buffer; backward, their gradients summed over the
    data axes through one flat fp32 buffer, each rank keeping its
    slice."""

    @staticmethod
    def forward(ctx, dims, *xs):
        import torch.distributed as dist
        mesh = _CTX.mesh
        i, n = _shard_index(mesh, _fsdp_axes(mesh))
        groups = fsdp_groups(mesh)
        whole = []
        for x, d in zip(xs, dims):
            s = list(x.shape)
            s[d] *= n
            whole.append(tuple(s))
        flat = torch.zeros(sum(math.prod(s) for s in whole),
                           dtype=xs[0].dtype, device=xs[0].device)
        out, at = [], 0
        for x, d, s in zip(xs, dims, whole):
            v = flat[at:at + math.prod(s)].view(s)
            v.narrow(d, i * x.shape[d], x.shape[d]).copy_(x)
            out.append(v)
            at += math.prod(s)
        for group in groups:
            dist.all_reduce(flat, group=group)
            _count("gathers", group, flat)
        ctx.dims, ctx.i, ctx.groups, ctx.whole = dims, i, groups, whole
        ctx.local = [(x.shape[d], x.dtype) for x, d in zip(xs, dims)]
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        import torch.distributed as dist
        flat = torch.cat([g.reshape(-1).float() for g in gs])
        for group in ctx.groups:
            dist.all_reduce(flat, group=group)
            _count("reduce_scatters", group, flat)
        out, at = [], 0
        for d, s, (loc, dt) in zip(ctx.dims, ctx.whole, ctx.local):
            mine = flat[at:at + math.prod(s)].view(s).narrow(
                d, ctx.i * loc, loc)
            # a copy of its own: a view would keep the whole flat buffer
            out.append(mine.to(dt, copy=True))
            at += math.prod(s)
        return (None, *out)


def fsdp_gather(tree, axes):
    """``tree`` (a layer's params, or the top-level leaves) with every
    leaf whose ``axes`` (from ``placed_axes``) name "fsdp" gathered over
    the data axes, in one flat buffer: an all-reduce over "pod" and
    "data" of a zero-filled buffer holding this rank's slices (gloo on
    CUDA tensors has no all-gather). Backward, each gathered leaf's
    gradient is summed over the same axes and the rank keeps its slice
    (the reference's reduce-scatter), so the train step must not sum
    it again. ``tree`` itself when no leaf is split. ``fsdp_gather.counts``
    holds, for the dry-run, ``{(kind, group size): [all-reduces, their
    buffers' bytes]}``, kind "gathers" or "reduce_scatters"."""
    pairs = list(_walk(tree, axes))
    split = [(k, tuple(a).index("fsdp")) for k, (_, a) in enumerate(pairs)
             if "fsdp" in a]
    if not split or not fsdp_on():
        return tree
    got = _FsdpGather.apply(tuple(d for _, d in split),
                            *(pairs[k][0] for k, _ in split))
    leaves = [x for x, _ in pairs]
    for (k, _), g in zip(split, got):
        leaves[k] = g
    return _rebuild(tree, leaves)


fsdp_gather.counts = {}


def _count(kind, group, flat):
    rec = fsdp_gather.counts.setdefault((kind, group.size()), [0, 0])
    rec[0] += 1
    rec[1] += flat.numel() * flat.element_size()


def fsdp_split(axes) -> bool:
    """Whether a leaf placed by ``axes`` is split over the data axes
    under the current rules (its gradient then summed by
    ``fsdp_gather``'s backward)."""
    return "fsdp" in tuple(axes) and fsdp_on()
