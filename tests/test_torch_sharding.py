"""The port's logical-axis sharding rules against the reference's, on the
reference's stand-in meshes (an object with a ``.shape`` dict of axis
sizes, as ``tests/test_extensions.py`` uses): pure logic, no process
group.

* ``DEFAULT_RULES`` equal the reference's.
* ``resolve_spec`` and ``apply_fsdp`` give the reference's specs over a
  parametrized set of shapes, logical axes and meshes.
* ``Model.axes()``, the shapes of ``Model.abstract()`` and
  ``Model.cache_axes()`` equal the reference's for every config of the
  catalog, layer by layer (the reference stacks a pattern group's layers
  along a leading "layers" dim; the port keeps one entry a layer, in the
  depth order of ``bridge``), and under meshes that do and do not
  sequence-shard the caches.
* ``launch.specs``' abstract inputs and their axes equal the reference's
  for every config and input shape.
* ``local_shape`` and ``local_slice`` agree with the placements the
  spec resolves to.
"""
import jax
import numpy as np
import pytest
import torch

from repro import sharding as jsharding
from repro.configs.base import ARCH_IDS, SHAPES
from repro.configs.base import get_config as jget_config
from repro.launch import specs as jspecs
from repro.models.model import get_model as jget_model
from repro_torch import bridge, sharding
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.configs.base import get_config as tget_config
from repro_torch.launch import specs as tspecs
from repro_torch.models.layers import PSpec, abstract_params, param_axes
from repro_torch.models.model import get_model as tget_model


class Mesh:
    """The reference tests' stand-in mesh: only ``.shape``."""

    def __init__(self, **shape):
        self.shape = shape

    def __repr__(self):
        return "x".join(f"{k}{v}" for k, v in self.shape.items())


MESHES = [Mesh(data=1, model=1), Mesh(data=2, model=2),
          Mesh(data=16, model=16), Mesh(data=1, model=16),
          Mesh(data=8, model=4), Mesh(pod=2, data=16, model=16),
          Mesh(data=4)]

CASES = [
    ((8, 128, 3, 64), ("batch", None, "kv_heads", None)),
    ((8, 128, 3, 64), ("batch", "kv_seq", None, None)),
    ((1, 524288, 1, 576), ("batch", "kv_seq", None, None)),
    ((64, 2048, 1408), ("experts", None, None)),
    ((4, 2048, 512), ("experts", None, None)),
    ((576, 576), (None, "heads")),
    ((49152, 576), ("vocab", None)),
    ((256, 4096), ("batch", None)),
    ((3, 4096), ("batch", None)),
    ((2048, 16384), ("fsdp", "ff")),
    ((32, 2048), ("fsdp", "heads")),
    ((16, 64, 128), ("ssm_heads", None, None)),
    ((4096,), ("lru",)),
    ((4, 4096), ("batch", "lru")),
    ((12, 576), ("layers", None)),
    ((7, 9), (None, None)),
    ((), ()),
]


def test_default_rules_equal_the_reference():
    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES


@pytest.mark.parametrize("mesh", MESHES, ids=repr)
@pytest.mark.parametrize("shape,axes", CASES,
                         ids=[f"{s}-{a}" for s, a in CASES])
def test_resolve_spec_equals_the_reference(shape, axes, mesh):
    want = jsharding.resolve_spec(shape, axes, mesh)
    got = sharding.resolve_spec(shape, axes, mesh)
    assert tuple(got) == tuple(want)
    assert tuple(sharding.named_sharding(shape, axes, mesh).spec) \
        == tuple(want)


def test_resolve_spec_without_a_mesh_is_empty():
    assert tuple(sharding.resolve_spec((4, 4), ("batch", None))) == ()
    with sharding.axis_rules(Mesh(data=2, model=2)):
        assert tuple(sharding.resolve_spec((4, 4), ("batch", "heads"))) \
            == ("data", "model")
    assert sharding.current_mesh() is None


def _ref_layers(cfg, ref_tree, abstract):
    """The reference's per-layer entries in the port's depth order: the
    stacked "layers" entry dropped (axes) or the group index taken
    (shapes)."""
    out = []
    for key, g in bridge._layer_order(cfg, abstract):
        node = ref_tree[key] if g is None else ref_tree["blocks"][key]
        out.append((node, g is not None))
    return out


def _strip(tree, stacked):
    if isinstance(tree, dict):
        return {k: _strip(v, stacked) for k, v in tree.items()}
    if stacked:
        assert tree[0] == "layers", tree
        return tuple(tree[1:])
    return tuple(tree)


def _shapes(tree, stacked):
    if isinstance(tree, dict):
        return {k: _shapes(v, stacked) for k, v in tree.items()}
    return tuple(tree.shape[1:] if stacked else tree.shape)


def _top(tree):
    return {k: v for k, v in tree.items()
            if not (k.startswith(("head_", "tail_")) or k == "blocks")}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_axes_and_abstract_equal_the_reference(arch):
    jm, tm = jget_model(jget_config(arch)), tget_model(tget_config(arch))
    cfg = tm.cfg
    jabs, jax_ = jm.abstract(), jm.axes()
    taxes, tabs = tm.axes(), tm.abstract()
    assert {k: tuple(v) for k, v in _top(jax_).items()} == \
        {k: v for k, v in taxes.items() if k != "layers"}
    assert {k: tuple(v.shape) for k, v in _top(jabs).items()} == \
        {k: tuple(v.shape) for k, v in tabs.items() if k != "layers"}
    ax_layers = _ref_layers(cfg, jax_, jabs)
    sh_layers = _ref_layers(cfg, jabs, jabs)
    assert len(ax_layers) == len(taxes["layers"]) == cfg.num_layers
    for i, ((ax, stacked), (sh, _)) in enumerate(zip(ax_layers, sh_layers)):
        assert _strip(ax, stacked) == taxes["layers"][i], i
        assert _shapes(sh, stacked) == _shapes(tabs["layers"][i], False), i
    assert all(t.device.type == "meta"
               for t in jax.tree.leaves(tabs))


CACHE_MESHES = [None, Mesh(data=1, model=2), Mesh(data=2, model=16),
                Mesh(data=4, model=4)]


@pytest.mark.parametrize("mesh", CACHE_MESHES, ids=repr)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_equal_the_reference(arch, mesh):
    jm, tm = jget_model(jget_config(arch)), tget_model(tget_config(arch))
    B, L = 8, 2048
    with jsharding.axis_rules(mesh):
        jaxes = jm.cache_axes(B, L)
        jspec = jm.cache_spec(B, L)
        jabs = jm.init_cache(B, L, abstract=True)
    with sharding.axis_rules(mesh):
        taxes = tm.cache_axes(B, L)
        tspec = tm.cache_spec(B, L)
    layers = _ref_layers(tm.cfg, jaxes, jabs)
    shapes = _ref_layers(tm.cfg, jax.tree.map(
        lambda sa: sa[0], jspec, is_leaf=lambda x: isinstance(x, tuple)
        and len(x) == 2 and isinstance(x[0], tuple)), jabs)
    for i, ((ax, stacked), (sh, _)) in enumerate(zip(layers, shapes)):
        assert _strip(ax["mixer"], stacked) == taxes[i], i
        want = {k: (tuple(v[1:]) if stacked else tuple(v))
                for k, v in sh["mixer"].items()}
        assert {k: sa[0] for k, sa in tspec[i].items()} == want, i


def _fsdp_cases():
    out = []
    for arch in ("qwen3-4b", "kimi-k2-1t-a32b", "smollm-135m"):
        for mesh in (Mesh(data=2, model=2), Mesh(data=16, model=16),
                     Mesh(data=1, model=4)):
            out.append((arch, mesh))
    return out


@pytest.mark.parametrize("arch,mesh", _fsdp_cases(),
                         ids=[f"{a}-{m!r}" for a, m in _fsdp_cases()])
def test_apply_fsdp_equals_the_reference(arch, mesh):
    """Layer by layer, on each layer's table (the reference's stacked
    leaves count their "layers" dim in fsdp's size threshold, so a
    stacked leaf is compared as the per-layer table it stacks), and on
    the top-level leaves."""
    tm = tget_model(tget_config(arch))
    tables = [tm.param_table()] + [tm.layer_table(i)
                                   for i in range(tm.cfg.num_layers)]
    for i, tab in enumerate(tables):
        jabs = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape, np.float32), tab,
            is_leaf=lambda x: isinstance(x, PSpec))
        want = jsharding.apply_fsdp(jabs, param_axes(tab), mesh=mesh)
        got = sharding.apply_fsdp(abstract_params(tab, torch.float32),
                                  param_axes(tab), mesh=mesh)
        assert want == got, i
    full = sharding.apply_fsdp(tm.abstract(), tm.axes(), mesh=mesh)
    assert full.keys() == tm.axes().keys()
    assert len(full["layers"]) == tm.cfg.num_layers


def test_apply_fsdp_shards_large_params():
    """``tests/test_extensions.py``'s FSDP case, on the port."""
    M = Mesh(data=8, model=4)
    meta = lambda *s: torch.empty(s, device="meta")
    shapes = {"w": meta(1024, 512), "tiny": meta(8), "already": meta(1024,
                                                                     64)}
    axes = {"w": (None, None), "tiny": (None,), "already": (None, "ff")}
    out = sharding.apply_fsdp(shapes, axes, mesh=M)
    assert "fsdp" in out["w"]
    assert out["tiny"] == (None,)
    assert "fsdp" in out["already"]
    assert "data" in str(sharding.resolve_spec((1024, 512), out["w"],
                                               mesh=M))


@pytest.mark.parametrize("mesh", [Mesh(data=2, model=2),
                                  Mesh(data=16, model=16)], ids=repr)
def test_tree_shardings_resolve_every_leaf(mesh):
    tm = tget_model(tget_config("kimi-k2-1t-a32b"))
    out = sharding.tree_shardings(tm.abstract(), tm.axes(), mesh)
    layer = out["layers"][1]["moe"]
    assert tuple(layer["we_gate"].spec)[0] == "model"
    assert tuple(out["embed"].spec) == tuple(jsharding.resolve_spec(
        tuple(tm.abstract()["embed"].shape), ("vocab", None), mesh))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch, shape):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    jkind, jinp = jspecs.input_specs(jcfg, SHAPES[shape])
    tkind, tinp = tspecs.input_specs(tcfg, TSHAPES[shape])
    assert jkind == tkind
    assert jinp.keys() == tinp.keys()
    for k in jinp:
        assert tuple(jinp[k].shape) == tuple(tinp[k].shape), k
        assert str(jinp[k].dtype) == str(tinp[k].dtype).removeprefix(
            "torch."), k
        assert tinp[k].device.type == "meta"
    assert jspecs.input_axes(jcfg, SHAPES[shape]) == \
        tspecs.input_axes(tcfg, TSHAPES[shape])
    assert jspecs.decode_window(jcfg, SHAPES[shape]) == \
        tspecs.decode_window(tcfg, TSHAPES[shape])
    assert jspecs.needs_sliding_window(jcfg, SHAPES[shape]) == \
        tspecs.needs_sliding_window(tcfg, TSHAPES[shape])
    assert jspecs.label_len(jcfg, 4096) == tspecs.label_len(tcfg, 4096)


class FakeMesh:
    """A DeviceMesh's face for ``local_slice`` without a process group:
    dim names, sizes and this rank's coordinate."""

    def __init__(self, coord, **shape):
        self.mesh_dim_names = tuple(shape)
        self.mesh = torch.zeros(tuple(shape.values()))
        self._coord = coord

    def get_coordinate(self):
        return list(self._coord)


@pytest.mark.parametrize("shape,axes", [
    ((8, 6, 4), ("batch", "kv_seq", None)),
    ((4, 8, 3), ("experts", None, None)),
    ((3, 8, 2), ("batch", "kv_seq", None)),
    ((8, 8), ("batch", "heads")),
])
def test_local_slices_tile_the_global_tensor(shape, axes):
    """Every rank's ``local_slice`` (under ``LOCAL_RULES``) has
    ``local_shape``, and the slices put back at their coordinates make
    the global tensor: each element exactly once."""
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    parts = {}
    for d in range(2):
        for m in range(2):
            mesh = FakeMesh((d, m), data=2, model=2)
            part = sharding.local_slice(x, axes, mesh)
            assert tuple(part.shape) == sharding.local_shape(shape, axes,
                                                             mesh)
            spec = sharding.resolve_spec(shape, axes, mesh,
                                         sharding.LOCAL_RULES)
            where = []
            for dim, e in enumerate(spec):
                i = 0 if e is None else {"data": d, "model": m}[e]
                step = shape[dim] // (1 if e is None else 2)
                where.append((i * step, (i + 1) * step))
            idx = tuple(slice(*w) for w in where)
            assert torch.equal(x[idx], part)
            assert torch.equal(parts.setdefault(tuple(where), part), part)
    count = torch.zeros_like(x)
    for where in parts:
        count[tuple(slice(*w) for w in where)] += 1
    assert torch.equal(count, torch.ones_like(x))
