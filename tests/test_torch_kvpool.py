"""The port's page pool against the reference's accounting.

The same operation sequence, drawn with numpy, runs on
``repro.serving.kvpool.PagePool(model=None)`` and on the port's pool; the
two must agree exactly after every step: refcounts, free list, prefix
index, page metadata, global and per-tier counters, telemetry and
``audit()``. The audit must trip on the same tampered states as the
reference's. A pool built with a model holds zeroed per-layer page
tensors, and copy-on-write copies every layer's page in place.
"""
import numpy as np
import pytest
import torch

from repro.serving import kvpool as jkv
from repro_torch.configs.base import get_config
from repro_torch.models.model import get_model
from repro_torch.serving import kvpool as tkv


def _state(p):
    return (p.refcount.tolist(), list(p._free), dict(p._prefix_index),
            {pid: (m.tier, m.key) for pid, m in p._meta.items()},
            dict(p.stats), {t: dict(d) for t, d in p.tier_stats.items()},
            p.tier_telemetry(), p.telemetry(), p.in_use_by_tier())


def _step(p, op, a, b, live, chashes):
    """One operation; ``live`` is the caller's own view of live pages."""
    tier = (None, 1, 2, 3)[a % 4]
    if op == "alloc":
        return p.alloc(tier)
    if op == "register":
        fresh = [q for q in live if p._meta[q].key is None]
        if fresh:       # a page holds one prefix chunk, registered once
            pid = fresh[b % len(fresh)]
            chash, fill = chashes[a % len(chashes)]
            p.register_prefix(pid, p._meta[pid].tier, chash, fill)
    elif op == "lookup":
        chash, fill = chashes[b % len(chashes)]
        return p.lookup_prefix(tier, chash, fill)
    elif op == "resolve":
        chash, fill = chashes[b % len(chashes)]
        return tkv.resolve_chunk_page(p, tier, chash, fill) \
            if isinstance(p, tkv.PagePool) \
            else jkv.resolve_chunk_page(p, tier, chash, fill)
    elif op == "incref" and live:
        p.incref(live[b % len(live)])
    elif op == "decref" and live:
        p.decref(live[b % len(live)])
    elif op == "cow" and live:
        return p.cow(live[b % len(live)], tier)
    elif op == "snapshot":
        snap = p.snapshot_share_counters()
        chash, fill = chashes[b % len(chashes)]
        p.lookup_prefix(tier, chash, fill)
        p.restore_share_counters(snap)
    elif op == "attach":
        p.note_admission_attach(tier, b % 3)
    elif op == "disable" and a == 0 and b % 7 == 0:
        p.disable_sharing()
    return None


OPS = ["alloc", "alloc", "register", "lookup", "resolve", "incref",
       "decref", "decref", "cow", "snapshot", "attach", "disable"]


@pytest.mark.parametrize("seed", range(6))
def test_same_operations_same_accounting(seed):
    rng = np.random.default_rng(seed)
    num_pages = int(rng.integers(3, 14))
    jp = jkv.PagePool(num_pages=num_pages, page_size=4)
    tp = tkv.PagePool(num_pages=num_pages, page_size=4)
    ids = rng.integers(3, 60, 24).tolist()
    chashes = tkv.prefix_chunk_hashes(ids, 4)
    assert chashes == jkv.prefix_chunk_hashes(ids, 4)
    for _ in range(120):
        op = OPS[int(rng.integers(len(OPS)))]
        a, b = int(rng.integers(0, 100)), int(rng.integers(0, 100))
        live = [q for q in range(1, num_pages) if jp.refcount[q] > 0]
        rj = _step(jp, op, a, b, live, chashes)
        rt = _step(tp, op, a, b, live, chashes)
        assert rt == rj, op
        assert _state(tp) == _state(jp), op
        assert tp.audit() and jp.audit()
        assert tp.in_use() == jp.in_use()
        assert tp.free_count() == jp.free_count()
        assert tp.occupancy() == jp.occupancy()


def test_trust_tier_mapping_matches():
    for s in np.linspace(0.0, 1.0, 41):
        assert tkv.trust_tier_for_sensitivity(float(s)) == \
            jkv.trust_tier_for_sensitivity(float(s))


def _registered(mod):
    p = mod.PagePool(num_pages=4, page_size=4)
    (chash, fill), = mod.prefix_chunk_hashes([1, 2, 3, 4], 4)
    pid = p.alloc(2)
    p.register_prefix(pid, 2, chash, fill)
    return p, pid, fill


def _tamper_conservation(mod):
    p = mod.PagePool(num_pages=4)
    p.alloc(tier=1)
    p.stats["frees"] += 1
    return p


def _tamper_free_dup(mod):
    p = mod.PagePool(num_pages=4)
    pid = p.alloc(tier=1)
    p.decref(pid)
    p._free.append(pid)
    return p


def _tamper_freed_metadata(mod):
    p = mod.PagePool(num_pages=4)
    pid = p.alloc(tier=1)
    p.decref(pid)
    p._meta[pid].tier = 2
    return p


def _tamper_index_meta(mod):
    p, pid, fill = _registered(mod)
    p._meta[pid].key = (2, "bogus", fill)
    return p


def _tamper_cross_tier(mod):
    p, pid, _ = _registered(mod)
    p._meta[pid].tier = 3
    return p


def _tamper_index_freed(mod):
    p = mod.PagePool(num_pages=4, page_size=4)
    p._prefix_index[(1, "dead", 4)] = 2
    return p


@pytest.mark.parametrize("tamper,match", [
    (_tamper_conservation, "conservation"),
    (_tamper_free_dup, "free list dup"),
    (_tamper_freed_metadata, "kept metadata"),
    (_tamper_index_meta, "index/meta disagree"),
    (_tamper_cross_tier, "cross-tier index entry"),
    (_tamper_index_freed, "points at freed"),
])
def test_audit_trips_like_reference(tamper, match):
    for mod in (jkv, tkv):
        with pytest.raises(AssertionError, match=match):
            tamper(mod).audit()


def test_double_free_and_scratch_are_errors():
    p = tkv.PagePool(num_pages=4)
    pid = p.alloc(tier=2)
    p.decref(pid)
    with pytest.raises(AssertionError):
        p.decref(pid)
    with pytest.raises(AssertionError):
        p.decref(tkv.SCRATCH_PAGE)


def test_device_pages_are_zeroed_and_cow_copies_every_layer():
    cfg = get_config("smollm-135m").reduced()
    p = tkv.PagePool(get_model(cfg), max_len=64, page_size=16, num_pages=6,
                     device="cpu")
    assert len(p.pages) == cfg.num_layers
    for layer in p.pages:
        for t in layer.values():
            assert t.shape == (6, 16, cfg.num_kv_heads, cfg.head_dim)
            assert t.dtype == torch.bfloat16 and not t.any()
    pid = p.alloc(1)
    for i, layer in enumerate(p.pages):
        layer["k_pages"][pid] = i + 1.0
        layer["v_pages"][pid] = -(i + 1.0)
    p.incref(pid)
    new = p.cow(pid)
    assert new not in (None, pid) and p.refcount[pid] == 1
    for i, layer in enumerate(p.pages):
        assert torch.equal(layer["k_pages"][new], layer["k_pages"][pid])
        assert torch.equal(layer["v_pages"][new], layer["v_pages"][pid])
    assert p.stats["cow_copies"] == 1 and p.audit()
    with pytest.raises(ValueError, match="multiple of page_size"):
        tkv.PagePool(num_pages=4, max_len=30, page_size=16)
