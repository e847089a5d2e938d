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
local layout resolves under: the reference's ``DEFAULT_RULES`` with
"fsdp" off (weights are not split over the data axes), so each rank
holds exactly the slice of a weight or a cache leaf the reference
places on its device: heads, kv heads, ff, vocab, ssm_heads and lru
tensor-parallel over "model", experts over "model", the batch over
"pod" and "data". A dim the model axis does not divide stays
replicated, as the rules say. ``local_slice`` takes a global tensor to
this rank's shard under a spec and ``gather_global`` is its inverse (an
all-reduce of a zero-filled global buffer, per mesh dim: gloo on CUDA
tensors has no all-gather). ``shard`` is the identity on a plain local
tensor and a ``redistribute`` on a DTensor.

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
# under: the reference's, with "fsdp" off (the ZeRO-3 placement of
# ``apply_fsdp`` is not carried: a rank holds every weight's model slice)
LOCAL_RULES = {**DEFAULT_RULES, "fsdp": ()}


class _Ctx:
    mesh = None
    rules: dict = DEFAULT_RULES


_CTX = _Ctx()


@contextmanager
def axis_rules(mesh, rules: dict | None = None):
    """Install a mesh + logical rules for ``shard()`` and
    ``named_sharding()`` resolution and for the model's mesh paths."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a stand-in's ``.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


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
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(like)


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
