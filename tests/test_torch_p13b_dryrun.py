"""The port's dry-run (P13b) on a fake process group, against the
reference's ``launch/mesh.py`` and ``launch/dryrun.py``.

One fake group lives for the module (``launch.mesh.fake_world``: 512
ranks, this process rank 0, collectives that return at once). The
fixture asserts that no group exists on entry and destroys its own on
exit.

* ``make_production_mesh``: the shapes, dim names, per-pod override and
  its refusal equal the reference's (run with ``jax.make_mesh`` replaced
  by a recorder); a group too small for the mesh is refused with both
  numbers.
* The ring estimates (``dryrun.ring_bytes``) equal the reference's
  ``parse_collectives`` on synthetic HLO lines of every kind and group
  size, exactly; ``StepCounter`` records a c10d collective with the
  estimate for its group's size.
* ``argument_bytes`` equals the reference's compiled
  ``memory_analysis().argument_size_in_bytes`` for smollm-135m
  ``.reduced()`` on one device, for train, prefill and decode.
* ``flops`` equals a count of the matmuls written out here, for a dense
  decode and prefill.
* ``param_bytes_by_rules`` equals the sum of the reference's
  ``resolve_spec`` shard shapes for every config at full width on the
  (16, 16) and (2, 16, 16) stand-in meshes (shapes only), with and
  without ``--fsdp`` (the reference's own ``apply_fsdp`` on its stacked
  tree).
* Every kernel wrapper and backward kernel takes its plain version on
  meta tensors: meta outputs of the kernel's shapes, no launch counted.
* Every config at ``.reduced()`` lowers train, prefill and decode on a
  fake (2, 2) mesh, each record's weights placed as the rules place them
  (``param_bytes_placed == param_bytes_by_rules``, since P13c), and the
  train step under a (pod, data, model) mesh sums its gradients over
  both batch axes.
* kimi-k2 and deepseek at ``.reduced()`` widths with their full expert
  counts (64 or more: the factored second moment, as the reference's
  dry-run sets it) lower their train step ok on the fake (2, 2) mesh; one
  production-mesh record (smollm-135m ``decode_32k`` on 16 x 16) places
  its weights as the rules do, with and without ``--fsdp`` (whose record
  counts a gather a layer and one of the embedding).
"""
import contextlib
import dataclasses
import json
import math
import os

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AxisType
from torch.distributed.device_mesh import DeviceMesh

from _torch_parity import other_device
from repro import sharding as jsharding
from repro.configs.base import ARCH_IDS
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import get_config as jget_config
from repro.launch import mesh as jmesh
from repro.models.model import get_model as jget_model
from repro_torch import sharding
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.configs.base import InputShape as TInputShape
from repro_torch.configs.base import get_config as tget_config
from repro_torch.kernels import (chunked_prefill, decode_attention,
                                 flash_attention, paged_attention, rglru,
                                 ssd)
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models.model import get_model as tget_model
from repro_torch.training.optim import tree_leaves


class Mesh:
    """The reference tests' stand-in mesh: only ``.shape``."""

    def __init__(self, **shape):
        self.shape = shape


@pytest.fixture(scope="module")
def fake_group():
    """A fake process group of 512 ranks for the module; ``join(n)``
    replaces it with one of ``n`` ranks."""
    assert not dist.is_initialized(), "a process group already exists"
    stack = contextlib.ExitStack()

    class Group:
        def join(self, n):
            stack.close()
            stack.enter_context(fake_world(n))

    group = Group()
    group.join(512)
    try:
        yield group
    finally:
        stack.close()
        assert not dist.is_initialized()


def _one_rank_mesh(**_):
    return DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))


def _small_shapes(monkeypatch, module_shapes, InputShape, S=64, B=2):
    """Put a small train, prefill and decode shape into a SHAPES dict."""
    names = {}
    for kind in ("train", "prefill", "decode"):
        name = f"tiny_{kind}"
        monkeypatch.setitem(module_shapes, name, InputShape(name, S, B,
                                                            kind))
        names[kind] = name
    return names


# ------------------------------------------------------ the production mesh

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", [None, (64, 4), (8, 32), (256, 1)])
def test_production_mesh_matches_reference(fake_group, monkeypatch,
                                           multi_pod, shape):
    calls = []
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda dims, names: calls.append((tuple(dims),
                                                          tuple(names))))
    jmesh.make_production_mesh(multi_pod=multi_pod, shape=shape)
    mesh = make_production_mesh(multi_pod=multi_pod, shape=shape,
                                device="cpu")
    assert calls == [(tuple(mesh.mesh.shape), mesh.mesh_dim_names)]
    assert tuple(mesh.get_coordinate()) == (0,) * mesh.mesh.dim()


@pytest.mark.parametrize("shape", [(8, 16), (16, 32), (1, 1)])
def test_production_mesh_refuses_what_the_reference_refuses(
        fake_group, monkeypatch, shape):
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda *a: None)
    for multi_pod in (False, True):
        with pytest.raises(AssertionError, match="256 chips"):
            jmesh.make_production_mesh(multi_pod=multi_pod, shape=shape)
        with pytest.raises(ValueError, match="one pod = 256 chips"):
            make_production_mesh(multi_pod=multi_pod, shape=shape,
                                 device="cpu")


def test_production_mesh_needs_enough_ranks(fake_group):
    fake_group.join(256)
    try:
        assert make_production_mesh(device="cpu").mesh.numel() == 256
        with pytest.raises(ValueError, match="a 2x16x16 mesh needs 512 "
                                             "ranks, the process group "
                                             "has 256"):
            make_production_mesh(multi_pod=True, device="cpu")
    finally:
        fake_group.join(512)


# ---------------------------------------------------------- collectives

HLO = {
    "all-reduce": "  %ar = f32[8,128]{1,0} all-reduce(f32[8,128]{1,0} %x), "
                  "replica_groups={G}, to_apply=%add",
    "all-gather": "  %ag = bf16[64,16]{1,0} all-gather(bf16[16,16]{1,0} "
                  "%x), replica_groups={G}, dimensions={0}",
    "reduce-scatter": "  %rs = f32[4,16]{1,0} reduce-scatter(f32[16,16]"
                      "{1,0} %x), replica_groups={G}, dimensions={0}, "
                      "to_apply=%add",
    "all-to-all": "  %aa = s32[16,16]{1,0} all-to-all(s32[16,16]{1,0} "
                  "%x), replica_groups={G}, dimensions={0}",
    "collective-permute": "  %cp = bf16[3,5,7]{2,1,0} collective-permute("
                          "bf16[3,5,7]{2,1,0} %x), source_target_pairs="
                          "{{0,1},{1,0}}",
}
OUT_BYTES = {"all-reduce": 8 * 128 * 4, "all-gather": 64 * 16 * 2,
             "reduce-scatter": 4 * 16 * 4, "all-to-all": 16 * 16 * 4,
             "collective-permute": 3 * 5 * 7 * 2}


def _groups(n):
    """Replica groups of size ``n`` among 16 devices, in the two
    spellings the reference's parser reads: one explicit group (it reads
    the first), and the iota form."""
    return ["{{" + ",".join(map(str, range(n))) + "}}",
            f"[{16 // n},{n}]<=[16]"]


def test_ring_estimates_match_parse_collectives(monkeypatch):
    jax.devices()      # the backend is up: the import's XLA_FLAGS are inert
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch.dryrun import parse_collectives
    checked = 0
    for kind, line in HLO.items():
        for n in (1, 2, 4, 8, 16):
            for groups in _groups(n):
                text = line.replace("{G}", groups)
                colls, total = parse_collectives(text, 16)
                # collective-permute has no replica groups: the device
                # count stands in, as in the reference
                size = 16 if kind == "collective-permute" else n
                want = colls[kind]["bytes"]
                assert tdry.ring_bytes(kind, OUT_BYTES[kind], size) == want
                assert total == want and colls[kind]["count"] == 1
                checked += 1
    assert checked == 50
    with pytest.raises(ValueError, match="no estimate"):
        tdry.ring_bytes("broadcast", 1, 2)


def test_step_counter_records_collectives(fake_group):
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    x = torch.empty(8, 128, device="meta")

    def step(x):
        dist.all_reduce(x, group=mesh.get_group("model"))
        dist.all_reduce(x, group=mesh.get_group("pod"))
        return x * 2

    low = tdry.count_step(step, x)
    nb = 8 * 128 * 4
    want = tdry.ring_bytes("all-reduce", nb, 16) + \
        tdry.ring_bytes("all-reduce", nb, 2)
    assert low.collectives == {"all-reduce": {"count": 2, "bytes": want}}
    assert low.collective_bytes == want
    assert low.memory["argument_bytes"] == nb
    assert low.memory["output_bytes"] == nb
    assert low.memory["temp_bytes"] == 0        # the product is returned
    assert low.bytes_accessed == 2 * nb          # x read, the product written


def test_step_counter_peak_of_intermediates():
    x = torch.empty(1024, device="meta")

    def step(x):
        a = x + 1              # 4 KiB live
        b = a * a              # 8 KiB live
        del a
        c = b.sum()            # b's 4 KiB and c's 4 bytes
        return c

    low = tdry.count_step(step, x)
    assert low.memory["temp_bytes"] == 2 * 4096
    assert low.memory["output_bytes"] == 4


# ------------------------------------------- records against the reference

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_argument_bytes_match_reference(fake_group, monkeypatch, kind):
    jax.devices()
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as jdry
    arch = "smollm-135m"
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    jnames = _small_shapes(monkeypatch, JSHAPES, JInputShape)
    _small_shapes(monkeypatch, TSHAPES, TInputShape)
    monkeypatch.setattr(jdry, "get_config", lambda a: jcfg)
    # Auto axes: this JAX makes Explicit ones by default, which the
    # reference's sharding constraints refuse
    monkeypatch.setattr(
        jdry, "make_production_mesh", lambda **kw: jax.make_mesh(
            (1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2))
    monkeypatch.setattr(tdry, "get_config", lambda a: tcfg)
    monkeypatch.setattr(tdry, "make_production_mesh", _one_rank_mesh)
    lowered, n_dev, jkind, _ = jdry.lower_one(arch, jnames[kind], False)
    want = lowered.compile().memory_analysis().argument_size_in_bytes
    low, t_dev, tkind, _ = tdry.lower_one(arch, jnames[kind], False)
    assert (t_dev, tkind) == (n_dev, jkind) == (1, kind)
    assert low.memory["argument_bytes"] == want


def _matmul_flops(cfg, tokens):
    """2 x in x out per token for every projection of a dense attention
    layer and its SwiGLU MLP."""
    d, hd = cfg.d_model, cfg.head_dim
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    per_token = 2 * (d * qd + 2 * d * kvd + qd * d + 3 * d * cfg.d_ff)
    return cfg.num_layers * tokens * per_token


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_flops_match_analytic_count(fake_group, monkeypatch, kind):
    arch = "smollm-135m"
    cfg = tget_config(arch).reduced()
    S, B = 64, 2
    names = _small_shapes(monkeypatch, TSHAPES, TInputShape, S=S, B=B)
    monkeypatch.setattr(tdry, "get_config", lambda a: cfg)
    monkeypatch.setattr(tdry, "make_production_mesh", _one_rank_mesh)
    low, _, _, _ = tdry.lower_one(arch, names[kind], False)
    H, D, V, d = cfg.num_heads, cfg.head_dim, cfg.vocab_size, cfg.d_model
    if kind == "decode":
        # one token a row against every one of the S cache slots: the
        # plain version scores them all (q.k and p.v)
        want = _matmul_flops(cfg, B) + cfg.num_layers * 4 * B * H * S * D \
            + 2 * B * d * V
    else:
        # the plain attention scores every (query, key) pair, and the
        # step takes the logits of every position before keeping the last
        want = _matmul_flops(cfg, B * S) \
            + cfg.num_layers * 4 * B * H * S * S * D + 2 * B * S * d * V
    assert low.flops == want


@pytest.mark.parametrize("multi_pod,fsdp", [
    (False, False), (True, False), (False, True), (True, True)],
    ids=["False", "True", "False-fsdp=True", "True-fsdp=True"])
def test_param_bytes_by_rules_match_reference_specs(multi_pod, fsdp):
    """With ``fsdp`` the reference's side is its own ``apply_fsdp`` on its
    stacked tree: a repeating group's norm scales are (L, d) there and
    split over the data axes, where the port's per-layer leaves are 1-D."""
    mesh = (Mesh(pod=2, data=16, model=16) if multi_pod
            else Mesh(data=16, model=16))
    for arch in ARCH_IDS:
        jm = jget_model(jget_config(arch))
        axes = jm.axes()
        if fsdp:
            axes = jsharding.apply_fsdp(jm.abstract(), axes, mesh)
        want = 0
        for s, ax in zip(jax.tree.leaves(jm.abstract()),
                         jax.tree.leaves(axes, is_leaf=lambda x:
                                         isinstance(x, tuple))):
            spec = jsharding.resolve_spec(s.shape, ax, mesh)
            n = math.prod(math.prod(mesh.shape[a] for a in (
                (e,) if isinstance(e, str) else e)) for e in spec if e)
            want += math.prod(s.shape) // n * s.dtype.itemsize
        tcfg = tget_config(arch)
        got = tdry.param_bytes(tget_model(tcfg), getattr(torch, tcfg.dtype),
                               mesh, fsdp=fsdp, rules=sharding.DEFAULT_RULES)
        assert got == want, arch


# ------------------------------------------------------- meta tensors

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _launch_counts():
    return (paged_attention.paged_decode_attention.launches,
            chunked_prefill.chunked_prefill_attention.launches,
            decode_attention.decode_attention.launches,
            flash_attention.flash_attention.launches,
            flash_attention.flash_attention_bwd.launches,
            ssd.ssd_chunk.launches, ssd.ssd_chunk_bwd.launches,
            rglru.rglru_scan.launches, rglru.rglru_scan_bwd.launches)


def _assert_meta(outs, shapes):
    outs = [o for o in outs if o is not None]
    assert [tuple(o.shape) for o in outs] == shapes
    assert all(o.device.type == "meta" for o in outs)


def test_wrappers_take_plain_versions_on_meta():
    before = _launch_counts()
    B, H, Hkv, D, S, P, ps = 2, 8, 2, 64, 48, 6, 16
    i32 = dict(dtype=torch.int32)
    _assert_meta([paged_attention.paged_decode_attention(
        _meta(B, H, D), _meta(P, ps, Hkv, D), _meta(P, ps, Hkv, D),
        _meta(B, 3, **i32), _meta(B, **i32))], [(B, H, D)])
    _assert_meta([chunked_prefill.chunked_prefill_attention(
        _meta(B, ps, H, D), _meta(P, ps, Hkv, D), _meta(P, ps, Hkv, D),
        _meta(B, 3, **i32), _meta(B, **i32))], [(B, ps, H, D)])
    _assert_meta([decode_attention.decode_attention(
        _meta(B, H, D), _meta(B, S, Hkv, D), _meta(B, S, Hkv, D),
        _meta(B, **i32))], [(B, H, D)])
    q, kv = _meta(B, S, H, D), _meta(B, S, Hkv, D)
    _assert_meta([flash_attention.flash_attention(q, kv, kv, window=16)],
                 [(B, S, H, D)])
    _assert_meta(flash_attention.flash_attention_bwd(
        q, kv, kv, q, _meta(B, S, H), q, D ** -0.5),
        [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)])
    nc, Q, Hs, Ps, N = 3, 16, 4, 16, 8
    x, dt, a = _meta(B, nc, Q, Hs, Ps), _meta(B, nc, Q, Hs), _meta(Hs)
    Bm = _meta(B, nc, Q, N)
    pieces = [(B, nc, Q, Hs, Ps), (B, nc, Hs, Ps, N), (B, nc, Hs),
              (B, nc, Q, Hs)]
    _assert_meta(ssd.ssd_chunk(x, dt, a, Bm, Bm), pieces)
    _assert_meta(ssd.ssd_chunk_bwd(x, dt, a, Bm, Bm, dt, x, None, None,
                                   None),
                 [(B, nc, Q, Hs, Ps), (B, nc, Q, Hs), (Hs,), (B, nc, Q, N),
                  (B, nc, Q, N)])
    ar, br, h0 = _meta(B, 5, 32), _meta(B, 5, 32), _meta(B, 32)
    _assert_meta([rglru.rglru_scan(ar, br, h0)], [(B, 5, 32)])
    _assert_meta(rglru.rglru_scan_bwd(ar, ar, h0, ar),
                 [(B, 5, 32), (B, 5, 32), (B, 32)])
    # the autograd Functions' backward on meta (K4, K5, K6)
    leaves = [t.requires_grad_() for t in (q, kv, x, dt, Bm, ar, br)]
    out = flash_attention.flash_attention(q, kv, kv).sum() \
        + sum(t.sum() for t in ssd.ssd_chunk(x, dt, a, Bm, Bm)) \
        + rglru.rglru_scan(ar, br).sum()
    _assert_meta(torch.autograd.grad(out, leaves),
                 [tuple(t.shape) for t in leaves])
    assert _launch_counts() == before
    # any device but CUDA and the plain versions' raises
    with pytest.raises(ValueError, match="no kernel for device xla"):
        decode_attention.decode_attention(
            other_device((B, H, D)), other_device((B, S, Hkv, D)),
            other_device((B, S, Hkv, D)), 3)


# --------------------------------------------------- every config, reduced

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_reduced_lowers(fake_group, monkeypatch, tmp_path, arch):
    cfg = tget_config(arch).reduced()
    names = _small_shapes(monkeypatch, TSHAPES, TInputShape)
    monkeypatch.setattr(tdry, "get_config", lambda a: cfg)
    monkeypatch.setattr(tdry, "make_production_mesh", lambda **kw: DeviceMesh(
        "cpu", torch.arange(4).reshape(2, 2),
        mesh_dim_names=("data", "model")))
    for kind, name in names.items():
        assert tdry.run_one(arch, name, False, tmp_path), kind
        rec = json.loads((tmp_path / f"{arch}__{name}__pod16x16.json")
                         .read_text())
        assert (rec["kind"], rec["n_devices"]) == (kind, 4)
        assert rec["flops"] > 0 and rec["memory"]["argument_bytes"] > 0
        assert rec["param_bytes_placed"] == rec["param_bytes_by_rules"]
        if kind == "train":       # the gradients' all-reduce over "data"
            assert rec["collectives"]["all-reduce"]["count"] >= 1
    # a combination recorded ok is skipped
    assert tdry.run_one(arch, names["decode"], False, tmp_path)


def test_train_step_reduces_over_pod_and_data(fake_group, monkeypatch):
    """Under a (pod, data, model) mesh the batch splits over "pod" and
    "data", so the train step sums its token count, gradients and loss
    over both (one all-reduce each over each axis)."""
    cfg = tget_config("smollm-135m").reduced()
    names = _small_shapes(monkeypatch, TSHAPES, TInputShape, B=4)
    monkeypatch.setattr(tdry, "get_config", lambda a: cfg)
    sizes = []

    def mesh(**kw):
        m = DeviceMesh("cpu", torch.arange(4).reshape(2, 2, 1),
                       mesh_dim_names=("pod", "data", "model"))
        sizes.extend(m.get_group(a).size() for a in ("pod", "data"))
        return m

    monkeypatch.setattr(tdry, "make_production_mesh", mesh)
    low, n_dev, _, _ = tdry.lower_one("smollm-135m", names["train"], True)
    n_params = sum(p.numel() for p in tree_leaves(
        tget_model(cfg).abstract()))
    # the token count (4 bytes), the flat fp32 gradients, the loss
    per_axis = [4, 4 * n_params, 4]
    want = sum(tdry.ring_bytes("all-reduce", b, 2) for b in per_axis) * 2
    assert (n_dev, sizes) == (4, [2, 2])
    assert low.collectives == {"all-reduce": {"count": 6, "bytes": want}}


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "deepseek-v2-lite-16b"])
def test_factored_train_records_are_ok(fake_group, monkeypatch, tmp_path,
                                       arch):
    full = tget_config(arch)
    cfg = dataclasses.replace(full.reduced(), num_experts=full.num_experts)
    names = _small_shapes(monkeypatch, TSHAPES, TInputShape)
    monkeypatch.setattr(tdry, "get_config", lambda a: cfg)
    monkeypatch.setattr(tdry, "make_production_mesh", lambda **kw: DeviceMesh(
        "cpu", torch.arange(4).reshape(2, 2),
        mesh_dim_names=("data", "model")))
    assert tdry.run_one(arch, names["train"], False, tmp_path)
    rec = json.loads((tmp_path / f"{arch}__{names['train']}__pod16x16.json")
                     .read_text())
    assert rec["ok"] and rec["kind"] == "train" and cfg.num_experts >= 64
    assert rec["param_bytes_placed"] == rec["param_bytes_by_rules"]
    # the factored moment's statistics of a model-split leaf are means
    # over "model": more all-reduces than the gradients' and the norm's
    assert rec["collectives"]["all-reduce"]["count"] > 3


def _production_record(fake_group, tmp_path, fsdp):
    """smollm-135m ``decode_32k`` on the 16 x 16 mesh: the record, its
    weights placed as the rules place them."""
    fake_group.join(256)
    try:
        assert tdry.run_one("smollm-135m", "decode_32k", False, tmp_path,
                            fsdp=fsdp)
    finally:
        fake_group.join(512)
    rec = json.loads((tmp_path / "smollm-135m__decode_32k__pod16x16.json")
                     .read_text())
    assert rec["n_devices"] == 256 and rec["fsdp"] == fsdp
    assert rec["param_bytes_placed"] == rec["param_bytes_by_rules"]
    cfg = tget_config("smollm-135m")
    assert rec["param_bytes_placed"] == tdry.param_bytes(
        tget_model(cfg), getattr(torch, cfg.dtype),
        Mesh(data=16, model=16), fsdp=fsdp, rules=sharding.DEFAULT_RULES)
    return rec, cfg


def test_production_record_places_weights_by_the_rules(fake_group,
                                                       tmp_path):
    rec, _ = _production_record(fake_group, tmp_path, False)
    assert "fsdp_collectives" not in rec


def test_production_fsdp_record_places_weights_by_the_rules(fake_group,
                                                            tmp_path):
    """Under ``--fsdp`` rank 0 holds the ZeRO-3 placement itself, less
    than without it, and the record counts one gather a layer and one of
    the embedding over the data axis (a decode step has no backward)."""
    rec, cfg = _production_record(fake_group, tmp_path, True)
    assert rec["param_bytes_placed"] < tdry.param_bytes(
        tget_model(cfg), getattr(torch, cfg.dtype),
        Mesh(data=16, model=16), rules=sharding.DEFAULT_RULES)
    got = rec["fsdp_collectives"]
    assert got["gathers"]["count"] == cfg.num_layers + 1
    assert got["gathers"]["bytes"] > 0
    assert got["reduce_scatters"] == {"count": 0, "bytes": 0.0}
    assert "fsdp_collectives" in rec["note"]
