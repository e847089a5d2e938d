"""Live migration and island churn on the port, held to the reference.

The cases of tests/test_migration.py run on the port (smollm-135m
``.reduced()``, weights bridged from the reference's seeded init):

* a request frozen at ANY boundary (queued, every prefill chunk, every
  decode token) and thawed on a fresh batcher produces exactly the
  no-churn stream, for the fused chunked, unfused, full-prefill and
  stacked managers, and for the stacked rows of mamba2-370m (conv tail
  and SSM state) and recurrentgemma-9b (K/V rings and RG-LRU state);
* kills and drains never strand or double-complete a request, and the
  streams stay bit-exact (the port against itself: greedy, on the CPU);
* trust is never laundered: untiered requests recompute, a mutated tail
  page never re-attaches, a destination less trusted than the KV's tier
  receives no pages (nor a dense row), and refcounts are conserved under
  arbitrary export/import/free interleavings (hypothesis);
* teardown is complete.

Two cases cross the packages: at the same freeze boundary the reference
and the port write the same ticket (every field exactly; page data within
one bf16 ulp or 1e-4: K/V computed by two frameworks round to bf16 from
fp32 values that differ by ~1e-6, which moves a value by one ulp where it
sits near a rounding boundary, and by more ulps only where it sits near
zero), and a page set the reference
exported, imported into a port pool, decodes to the reference's
continuation under the margin rule of ``_torch_parity``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from _hypothesis_shim import given, settings, st
from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from _torch_parity import (assert_streams_match, capture_port,
                           capture_reference, reference_steps)
from repro.configs.base import get_config as jget_config
from repro.models.model import get_model as jget_model
from repro.serving.batcher import PagedContinuousBatcher as JBatcher
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.core.islands import (STATUS_DRAINING, STATUS_FAILED,
                                      IslandRegistry, edge_island,
                                      personal_island)
from repro_torch.core.lighthouse import Lighthouse
from repro_torch.core.mist import MIST
from repro_torch.core.tide import TIDE
from repro_torch.core.waves import WAVES, Policy, Request
from repro_torch.models.model import get_model
from repro_torch.serving.batcher import (ContinuousBatcher,
                                         PagedContinuousBatcher,
                                         make_batcher)
from repro_torch.serving.engine import TickOrchestrator, build_island_batchers
from repro_torch.serving.kvpool import (PagePool, export_request,
                                        import_request, prefix_chunk_hashes)
from repro_torch.serving.migration import MigrationTicket, PageRecord
from repro_torch.serving.session import SessionManager

# one torch thread, and the reference's step functions shared by
# every batcher of a config (``_torch_parity.lean_cpu``)
pytestmark = pytest.mark.usefixtures("lean_cpu")

CPU = "cpu"
PROMPTS = ["a somewhat longer request that spans multiple pages here",
           "short one"]


@pytest.fixture(scope="module")
def ref():
    jcfg = jget_config("smollm-135m").reduced()
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), "float32")
    return jcfg, jmodel, jparams


@pytest.fixture(scope="module")
def cfg():
    return get_config("smollm-135m").reduced()


@pytest.fixture(scope="module")
def params(cfg, ref):
    return bridge.from_reference(cfg, jax.device_get(ref[2]))


# ------------------------------------------------- batcher-level freeze/thaw

MODES = {
    "chunked": (PagedContinuousBatcher,
                dict(page_size=16, prefill_token_budget=16)),
    "unfused": (PagedContinuousBatcher,
                dict(page_size=16, prefill_token_budget=16, fused=False)),
    "full": (PagedContinuousBatcher, dict(page_size=16, prefill="full")),
    "stacked": (ContinuousBatcher, {}),
}


def _make(cfg, params, mode, **kw):
    cls, mkw = MODES[mode]
    return cls(cfg, params=params, num_slots=2, max_len=96, device=CPU,
               **dict(mkw, **kw))


def _sweep(cfg, params, mode, prompts=PROMPTS, max_new=5, **kw):
    """Freeze every live request after k source ticks for every k until
    the source finishes first, thaw on a fresh batcher, and return the
    phases seen, the largest k and the destinations' migration stats."""
    b0 = _make(cfg, params, mode, **kw)
    rids0 = [b0.submit(p, max_new_tokens=max_new, trust_tier=2)
             for p in prompts]
    done0 = b0.run_until_done()
    base = [done0[r] for r in rids0]
    k, phases, stats = 0, set(), []
    while True:
        a = _make(cfg, params, mode, **kw)
        b = _make(cfg, params, mode, **kw)
        rids = [a.submit(p, max_new_tokens=max_new, trust_tier=2)
                for p in prompts]
        for _ in range(k):
            a.tick()
        moved = {}
        for rid in rids:
            if rid in a.finished:
                continue
            t = a.freeze_request(rid)
            assert t is not None
            phases.add(t.phase)
            moved[rid] = b.submit_ticket(t)
        a.run_until_done()
        b.run_until_done()
        out = [b.finished[moved[r]] if r in moved else a.finished[r]
               for r in rids]
        assert out == base, f"{mode}: stream diverged at boundary k={k}"
        for x in (a, b):
            if hasattr(x, "pool"):
                assert x.pool.audit() and x.pool.in_use() == 0
                assert x.reserved == 0
        stats.append(dict(b.migration_stats))
        if not moved:
            return phases, k, stats
        k += 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_freeze_thaw_bitexact_at_every_boundary(cfg, params, mode):
    """Every boundary of the run, queued, mid-prefill (budget one chunk)
    and mid-decode: the combined streams equal the no-churn run, pools end
    empty and audited on both sides. Paged chunked thaws import pages;
    full-prefill thaws recompute; stacked thaws import the dense row."""
    phases, k, stats = _sweep(cfg, params, mode)
    assert k > 3
    imports = sum(s["imports"] for s in stats)
    recomputes = sum(s["recomputes"] for s in stats)
    if mode in ("chunked", "unfused"):
        assert phases >= {"queued", "prefill", "decode"}
        assert imports > 0 and sum(s["imported_pages"] for s in stats) > 0
    elif mode == "full":
        assert phases >= {"queued", "decode"}
        assert imports > 0 or recomputes > 0
    else:
        assert phases >= {"queued", "decode"} and imports > 0


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_stacked_state_rows_freeze_and_thaw_bitexact(arch):
    """A mamba2 row (bf16 conv tail, fp32 SSM state) and a
    recurrentgemma row (K/V rings, conv tail, RG-LRU state) travel as raw
    bits: every boundary thaws to the no-churn stream, by import; a
    destination with another ``max_len`` recomputes, and still matches."""
    acfg = get_config(arch).reduced()
    a0 = ContinuousBatcher(acfg, num_slots=2, max_len=96, device=CPU)
    phases, k, stats = _sweep(acfg, a0.params, "stacked")
    assert k > 2 and "decode" in phases
    assert sum(s["imports"] for s in stats) > 0
    # the shape check: max_len 64 on the destination recomputes
    base = ContinuousBatcher(acfg, params=a0.params, num_slots=2,
                             max_len=96, device=CPU)
    r = base.submit(PROMPTS[0], max_new_tokens=5)
    want = base.run_until_done()[r]
    a = ContinuousBatcher(acfg, params=a0.params, num_slots=2, max_len=96,
                          device=CPU)
    b = ContinuousBatcher(acfg, params=a0.params, num_slots=2, max_len=64,
                          device=CPU)
    r = a.submit(PROMPTS[0], max_new_tokens=5)
    a.tick()
    a.tick()
    nr = b.submit_ticket(a.freeze_request(r))
    assert b.run_until_done()[nr] == want
    assert b.migration_stats == dict(b.migration_stats, imports=0,
                                     recomputes=1)


def test_untiered_request_always_recomputes(cfg, params):
    """Untiered KV (trust_tier=None) never ships pages: the thaw goes
    through recompute, and the stream still matches."""
    kw = dict(params=params, num_slots=1, max_len=96, page_size=16,
              device=CPU)
    b0 = PagedContinuousBatcher(cfg, **kw)
    r0 = b0.submit(PROMPTS[0], max_new_tokens=5, trust_tier=None)
    base = b0.run_until_done()[r0]
    a = PagedContinuousBatcher(cfg, **kw)
    b = PagedContinuousBatcher(cfg, **kw)
    rid = a.submit(PROMPTS[0], max_new_tokens=5, trust_tier=None)
    for _ in range(3):
        a.tick()
    nr = b.submit_ticket(a.freeze_request(rid))
    b.run_until_done()
    assert b.finished[nr] == base
    assert b.migration_stats["imports"] == 0
    assert b.migration_stats["recomputes"] == 1
    assert b.pool.stats["import_refused"] >= 1


def test_mutated_tail_page_never_reattaches_by_stale_key(cfg, params):
    """A tail page registered for a PARTIAL prompt chunk and then extended
    by decode tokens must deep-copy on import: the destination holds a
    less advanced decode of the same prompt, whose same-key page would
    graft stale K/V at the migrated positions."""
    prompt = "x" * 19                 # + BOS = 20 tokens: 16 + partial 4
    kw = dict(params=params, num_slots=2, max_len=96, page_size=16,
              device=CPU)
    b0 = PagedContinuousBatcher(cfg, **kw)
    r0 = b0.submit(prompt, max_new_tokens=10, trust_tier=2)
    base = b0.run_until_done()[r0]
    a = PagedContinuousBatcher(cfg, **kw)
    b = PagedContinuousBatcher(cfg, **kw)
    rb = b.submit(prompt, max_new_tokens=10, trust_tier=2)
    for _ in range(2):
        b.tick()
    ra = a.submit(prompt, max_new_tokens=10, trust_tier=2)
    for _ in range(6):
        a.tick()

    def progress(bb):
        s = bb.slots[0]
        return len(s.generated) + s.gen_dev

    assert progress(a) > progress(b) > 0
    t = a.freeze_request(ra)
    assert any(r.key is not None and r.fill != r.key[2] for r in t.pages)
    nra = b.submit_ticket(t)
    a.run_until_done()
    done = b.run_until_done()
    assert done[nra] == base and done[rb] == base
    assert b.pool.stats["imported_pages"] >= 1
    assert b.pool.audit() and b.pool.in_use() == 0


def test_freeze_mid_fused_tick_serializes_identically(cfg, params):
    """A request frozen after k ticks of a FUSED batcher serializes to the
    ticket the unfused batcher writes at the same k (the fused path
    materializes its device tail), page bits included, for every k."""
    def freeze_at(fused, k):
        b = PagedContinuousBatcher(cfg, params=params, num_slots=2,
                                   max_len=96, page_size=16,
                                   prefill_token_budget=16, fused=fused,
                                   device=CPU)
        rids = [b.submit(p, max_new_tokens=5, trust_tier=2)
                for p in PROMPTS]
        for _ in range(k):
            b.tick()
        return [b.freeze_request(rid) for rid in rids]

    k, phases = 0, set()
    while True:
        frozen = list(zip(freeze_at(False, k), freeze_at(True, k)))
        for tu, tf in frozen:
            assert (tu is None) == (tf is None)
            if tu is None:
                continue
            phases.add(tf.phase)
            for f in ("prompt", "prompt_ids", "generated", "max_new",
                      "tier", "kv_tokens", "page_size", "phase",
                      "sample_key"):
                assert getattr(tf, f) == getattr(tu, f), (k, f)
            assert len(tf.pages) == len(tu.pages)
            for pu, pf in zip(tu.pages, tf.pages):
                assert (pf.tier, pf.key, pf.fill) == (pu.tier, pu.key,
                                                      pu.fill)
                for lu, lf in zip(pu.data, pf.data):
                    np.testing.assert_array_equal(lf, lu)
        if all(t is None for t, _ in frozen):
            break
        k += 1
    assert k > 3 and phases >= {"queued", "prefill", "decode"}


def test_stochastic_stream_survives_migration(cfg, params):
    """temperature > 0: the per-slot sampling key travels with the
    ticket, so a mid-decode import on a batcher with another seed
    continues the exact stochastic stream the source would have
    produced."""
    kw = dict(params=params, num_slots=1, max_len=96, page_size=16,
              temperature=0.8, seed=7, device=CPU)
    b0 = PagedContinuousBatcher(cfg, **kw)
    r0 = b0.submit(PROMPTS[0], max_new_tokens=6, trust_tier=2)
    base = b0.run_until_done()[r0]
    a = PagedContinuousBatcher(cfg, **kw)
    b = PagedContinuousBatcher(cfg, **dict(kw, seed=99))
    rid = a.submit(PROMPTS[0], max_new_tokens=6, trust_tier=2)
    for _ in range(3):
        a.tick()
    t = a.freeze_request(rid)
    assert t.sample_key is not None and t.sample_key[1] > 0
    nr = b.submit_ticket(t)
    b.run_until_done()
    assert b.finished[nr] == base
    assert b.migration_stats["imports"] == 1


# ------------------------------------------------ orchestrator fault injection

def _mesh(cfg, params, islands=None, **bkw):
    reg = IslandRegistry()
    for isl in islands or [
            personal_island("laptop", latency_ms=120, capacity_units=2.0),
            personal_island("desktop", latency_ms=150, capacity_units=2.0),
            personal_island("nas", latency_ms=200, capacity_units=2.0)]:
        reg.register(isl, reg.attestation_token(isl.island_id))
    mist, tide, lh = MIST(), TIDE(reg), Lighthouse(reg)
    for i in reg.all():
        lh.heartbeat(i.island_id)
    waves = WAVES(mist, tide, lh, Policy())
    bats = build_island_batchers(cfg, reg, cache=bkw.pop("cache", "paged"),
                                 max_len=96, slots_per_capacity_unit=2.0,
                                 params=params, device=CPU, **bkw)
    orch = TickOrchestrator(waves, reg, bats, decode_ticks_per_tick=1,
                            migration_token_budget=256, device=CPU)
    return reg, tide, lh, orch


CHURN_PROMPTS = [f"patient record number {i} with several details attached"
                 for i in range(6)]


def _drive(orch, events=(), max_ticks=400):
    rids = [orch.submit(Request(query=p, priority="primary",
                                sensitivity_override=0.3),
                        max_new_tokens=8) for p in CHURN_PROMPTS]
    events = dict(events)
    k = 0
    while orch.busy() and orch.tick_stats["ticks"] < max_ticks:
        orch.tick()
        k += 1
        if k in events:
            events.pop(k)()
    assert not orch.busy(), "run hit the tick cap"
    return {r: (orch.results[r].text if orch.results.get(r) else None)
            for r in rids}


def test_kill_island_mid_flight_every_boundary(cfg, params):
    """Fail the busiest island after k orchestrator ticks for every k in
    the run's span: no request is lost or double-completed and every
    stream is bit-exact against the no-churn run."""
    _reg, _tide, _lh, o0 = _mesh(cfg, params)
    base = _drive(o0)
    assert all(t is not None for t in base.values())
    span = o0.tick_stats["ticks"]
    failovers = 0
    for k in range(1, min(span, 6) + 1):
        reg, _tide, _lh, orch = _mesh(cfg, params)
        out = _drive(orch, events={k: lambda: orch.fail_island("laptop")})
        assert out == base, f"divergence after kill at tick {k}"
        assert reg.status("laptop") == STATUS_FAILED
        failovers += orch.tick_stats["failovers"]
        done = [r for r, t in out.items() if t is not None]
        assert len(orch.log) == len(done)
        for b in orch.batchers.values():
            assert b.pool.audit() and b.pool.in_use() == 0
    assert failovers >= 1, "no kill ever caught work in flight"


def test_kill_mid_prefill_with_tiny_budget(cfg, params):
    """A one-chunk prefill budget spreads prefill over many ticks, so the
    kill lands between chunk dispatches; the rerun still matches."""
    def mesh():
        reg, tide, lh, orch = _mesh(cfg, params, prefill_token_budget=16)
        return reg, orch
    _reg, o0 = mesh()
    base = _drive(o0)
    _reg, orch = mesh()
    out = _drive(orch, events={2: lambda: orch.fail_island("laptop")})
    assert out == base
    assert orch.tick_stats["failovers"] >= 1


def test_drain_island_migrates_and_deregisters(cfg, params):
    """Graceful drain: in-flight work freezes off the island under the
    token budget, re-routes through WAVES and resumes bit-exactly; the
    empty island deregisters and every layer forgets it."""
    _reg, _t, _l, o0 = _mesh(cfg, params)
    base = _drive(o0)
    reg, tide, lh, orch = _mesh(cfg, params)
    out = _drive(orch, events={1: lambda: orch.drain_island(
        "laptop", deregister=True)})
    assert out == base
    assert orch.tick_stats["migrations_started"] >= 1
    assert orch.tick_stats["migrations"] >= 1
    assert orch.tick_stats["islands_drained"] == 1
    assert "laptop" not in reg
    assert "laptop" not in orch.batchers
    assert "laptop" not in tide.state
    assert "laptop" not in lh._last_beat
    assert "laptop" not in lh.pool_telemetry()
    assert all(i.island_id != "laptop" for i in lh.get_islands())
    assert lh.mesh_migration_stats()["import_tier_mismatch"] == 0
    assert orch.stats()["migration"]["imports"] >= 1
    for b in orch.batchers.values():
        for rec in b.request_log.values():
            assert rec.get("ttft_work", 0) >= 0
            assert rec.get("ttft_ticks", 0) >= 0


def test_drain_excludes_island_from_routing_immediately(cfg, params):
    """A draining island takes no new work even before it empties, yet it
    keeps serving what it holds."""
    reg, tide, lh, orch = _mesh(cfg, params)
    orch.tick()
    orch.drain_island("laptop")
    assert reg.status("laptop") == STATUS_DRAINING
    assert tide.capacity("laptop") == 0.0
    assert not tide.admits("laptop", "primary")
    assert all(i.island_id != "laptop" for i in lh.get_islands())
    rid = orch.submit(Request(query="late arrival", priority="primary",
                              sensitivity_override=0.3), max_new_tokens=3)
    while orch.busy() and orch.tick_stats["ticks"] < 300:
        orch.tick()
    assert orch.results[rid] is not None
    assert orch.results[rid].island_id != "laptop"


DOWNHILL = [personal_island("laptop", latency_ms=120, capacity_units=2.0),
            edge_island("edge", privacy=0.9, latency_ms=200,
                        capacity_units=4.0)]


def _downhill(cfg, params, churn, cache="paged"):
    reg, tide, lh, orch = _mesh(cfg, params, islands=DOWNHILL, cache=cache)
    # sensitivity 0.85 -> KV tier 1; prev_privacy matches the edge island
    # so the move keeps the same query text and the import rule is what is
    # under test
    rid = orch.submit(Request(query="summarize my medical history",
                              priority="secondary",
                              sensitivity_override=0.85,
                              prev_privacy=0.9), max_new_tokens=8)
    k = 0
    while orch.busy() and orch.tick_stats["ticks"] < 300:
        orch.tick()
        k += 1
        if churn and k == 2:
            orch.drain_island("laptop")
    return orch.results[rid].text, orch, lh


@pytest.mark.parametrize("cache", ["paged", "stacked"])
def test_tier_rule_forbids_kv_import_downhill(cfg, params, cache):
    """Tier-1 KV drained toward a tier-2 island arrives by recompute,
    never by raw KV (page records, or a stacked dense row), and the
    stream still matches the no-churn run."""
    base, _o, _l = _downhill(cfg, params, False, cache)
    text, orch, lh = _downhill(cfg, params, True, cache)
    assert text == base
    assert orch.tick_stats["migrations_started"] >= 1
    edge_b = orch.batchers["edge"]
    assert edge_b.migration_stats["imports"] == 0
    assert edge_b.migration_stats["recomputes"] >= 1
    if cache == "paged":
        assert edge_b.pool.stats["imported_pages"] == 0
        assert lh.mesh_migration_stats()["import_tier_mismatch"] == 0


def _solo(cfg, params, query, drain):
    one = [personal_island("solo", latency_ms=120, capacity_units=2.0)]
    reg, _tide, _lh, orch = _mesh(cfg, params, islands=one)
    rid = orch.submit(Request(query=query, priority="primary",
                              sensitivity_override=0.3), max_new_tokens=8)
    k = 0
    while orch.busy() and orch.tick_stats["ticks"] < 300:
        orch.tick()
        k += 1
        if drain is not None and k == 2:
            drain(orch)
    return reg, orch, orch.results[rid]


def test_drain_with_no_destination_finishes_at_source(cfg, params):
    """Draining the ONLY eligible island must not drop its in-flight
    work: the frozen request returns to the source and finishes there,
    bit-exact, frozen once (the backoff pins it)."""
    q = "only island in the mesh"
    _r, _o, base = _solo(cfg, params, q, None)
    reg, orch, res = _solo(cfg, params, q,
                           lambda o: o.drain_island("solo"))
    assert res is not None and res.text == base.text
    assert orch.tick_stats["migration_returns"] >= 1
    assert orch.tick_stats["migrations_started"] == 1
    assert reg.status("solo") == STATUS_DRAINING
    assert orch.tick_stats["islands_drained"] == 1


def test_drain_deregister_same_tick_never_drops_work(cfg, params):
    """drain_island(deregister=True) on the only island does NOT
    deregister in the tick it froze work: the ticket needs the island as
    its return-to-source fallback."""
    q = "lone island deregister drain"
    _r, _o, base = _solo(cfg, params, q, None)
    reg, orch, res = _solo(
        cfg, params, q, lambda o: o.drain_island("solo", deregister=True))
    assert res is not None and res.text == base.text
    assert orch.tick_stats["migration_returns"] >= 1
    assert "solo" not in reg


@pytest.mark.parametrize("long_q,max_new", [
    ("c" * 120, 6),    # context alone exceeds the small batcher
    ("c" * 60, 40),    # context fits; context + owed tokens does not
])
def test_unfit_destination_returns_ticket_to_source(cfg, params, long_q,
                                                    max_new):
    """A resumed request the destination batcher cannot hold bounces back
    to the draining source and finishes there bit-exactly."""
    def drive(churn):
        reg = IslandRegistry()
        for isl in [personal_island("big", latency_ms=120,
                                    capacity_units=2.0),
                    personal_island("small", latency_ms=150,
                                    capacity_units=2.0)]:
            reg.register(isl, reg.attestation_token(isl.island_id))
        mist, tide, lh = MIST(), TIDE(reg), Lighthouse(reg)
        for i in reg.all():
            lh.heartbeat(i.island_id)
        waves = WAVES(mist, tide, lh, Policy())
        bats = {"big": make_batcher(cfg, cache="paged", num_slots=2,
                                    max_len=192, params=params, device=CPU),
                "small": make_batcher(cfg, cache="paged", num_slots=2,
                                      max_len=96, params=params,
                                      device=CPU)}
        orch = TickOrchestrator(waves, reg, bats, decode_ticks_per_tick=1,
                                migration_token_budget=512, device=CPU)
        rid = orch.submit(Request(query=long_q, priority="primary",
                                  sensitivity_override=0.3),
                          max_new_tokens=max_new)
        k = 0
        while orch.busy() and orch.tick_stats["ticks"] < 300:
            orch.tick()
            k += 1
            if churn and k == 2:
                orch.drain_island("big")
        return orch.results[rid], orch

    base, _o = drive(False)
    res, orch = drive(True)
    assert res is not None and res.text == base.text
    assert orch.tick_stats["migration_returns"] >= 1
    assert res.island_id == "big"


def test_straggler_is_hedged_through_the_drain_path(cfg, params):
    """A TIDE-flagged straggler is evacuated like a draining island (the
    hedge), and the streams do not change."""
    _reg, _t, _l, o0 = _mesh(cfg, params)
    base = _drive(o0)
    _reg, tide, _l, orch = _mesh(cfg, params)
    out = _drive(orch, events={
        2: lambda: tide._stragglers.add("laptop"),
        4: lambda: tide._stragglers.discard("laptop")})
    assert out == base
    assert orch.tick_stats["hedges"] >= 1


def test_deregister_teardown_without_churn():
    """A plain deregister (no orchestrator) tears down TIDE and LIGHTHOUSE
    per-island state through the registry hooks."""
    reg = IslandRegistry()
    isl = personal_island("gone", latency_ms=100)
    reg.register(isl, reg.attestation_token("gone"))
    tide, lh = TIDE(reg), Lighthouse(reg)
    lh.heartbeat("gone")
    tide.add_load("gone", 0.5)
    lh.report_pool("gone", {"in_use": 1})
    reg.deregister("gone")
    assert "gone" not in tide.state and "gone" not in lh._last_beat
    assert "gone" not in lh.pool_telemetry()
    assert reg.status("gone") == STATUS_FAILED
    reg.deregister("gone")


def test_session_chat_runs_on_the_orchestrator(cfg, params):
    """``SessionManager`` (a verbatim copy) drives the port's
    orchestrator through ``submit_sync`` and keeps the history."""
    _reg, _t, _l, orch = _mesh(cfg, params)
    sm = SessionManager(orch)
    for q in ("first turn about my schedule", "and a second turn"):
        resp = sm.chat("s1", q, max_new_tokens=4,
                       sensitivity_override=0.3)
        assert resp is not None and resp.island_id in orch.batchers
    s = sm.get("s1")
    assert len(s.history) == 4 and len(s.islands_visited) == 2


# ----------------------------------------------------- hypothesis properties

@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["new", "export", "import",
                                           "free"]),
                          st.integers(0, 30), st.integers(1, 3)),
                max_size=40))
def test_refcounts_conserved_across_export_import_free(ops):
    """Arbitrary export/import/free interleavings across two pools never
    leak or double-free: ``audit()`` holds after every op, and the pages
    in use equal the tracked requests' pages."""
    pools = [PagePool(num_pages=12), PagePool(num_pages=12)]
    reqs, tickets, next_id = {}, {}, 0
    for op, arg, tier in ops:
        if op == "new":
            pi = arg % 2
            pages = []
            for _ in range(1 + arg % 3):
                pid = pools[pi].alloc(tier)
                if pid is None:
                    break
                pages.append(pid)
            if pages:
                reqs[next_id] = (pi, tier, pages)
                next_id += 1
        elif op == "export" and reqs:
            rid = sorted(reqs)[arg % len(reqs)]
            pi, rtier, pages = reqs.pop(rid)
            tickets[rid] = (rtier, export_request(pools[pi], pages,
                                                  len(pages) * 16))
        elif op == "import" and tickets:
            rid = sorted(tickets)[arg % len(tickets)]
            rtier, recs = tickets.pop(rid)
            pi = arg % 2
            got = import_request(pools[pi], recs, rtier)
            if got is not None:
                reqs[rid] = (pi, rtier, got[0])
        elif op == "free" and reqs:
            rid = sorted(reqs)[arg % len(reqs)]
            pi, _t, pages = reqs.pop(rid)
            for pid in pages:
                pools[pi].decref(pid)
        for p in pools:
            p.audit()
    for pi in (0, 1):
        held = sum(len(pages) for i, _t, pages in reqs.values() if i == pi)
        assert pools[pi].in_use() == held


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 3),
                          st.integers(0, 2), st.integers(1, 48)),
                min_size=1, max_size=10))
def test_migrated_pages_never_cross_tiers(moves):
    """Pages exported at tier A only ever attach or register at tier A in
    the destination; mismatched-tier and untiered imports refuse."""
    ps = 16
    src = PagePool(num_pages=64, page_size=ps, max_len=ps * 16)
    dst = PagePool(num_pages=64, page_size=ps, max_len=ps * 16)
    families = {0: [7] * 64, 1: [7] * 32 + [9] * 32, 2: [11] * 64}
    for et_idx, it_idx, fam, ln in moves:
        etier = None if et_idx == 3 else 1 + et_idx
        itier = None if it_idx == 3 else 1 + it_idx
        ids = families[fam][:ln]
        pages = []
        for chash, fill in prefix_chunk_hashes(ids, ps):
            pid = src.alloc(etier)
            if pid is None:
                break
            src.register_prefix(pid, etier, chash, fill)
            pages.append(pid)
        if not pages:
            continue
        got = import_request(dst, export_request(src, pages, len(ids)),
                             itier)
        if itier is None or itier != etier:
            assert got is None, "cross-tier/untiered import must refuse"
        elif got is not None:
            for pid in got[0]:
                assert dst._meta[pid].tier == etier
            for pid in got[0]:
                dst.decref(pid)
        src.audit()
        dst.audit()
    for pool in (src, dst):
        for (tier, _h, _f), pid in pool._prefix_index.items():
            assert pool._meta[pid].tier == tier


def test_pool_import_is_all_or_nothing_and_bit_exact(cfg, params):
    """A real pool: imported pages hold exactly the exported bits; a
    record without data refuses the whole import on a pool with K/V; an
    exhausted pool rolls back."""
    a = PagePool(get_model(cfg), max_len=64, page_size=16, num_pages=6,
                 device=CPU)
    rng = np.random.default_rng(0)
    pids = [a.alloc(2) for _ in range(3)]
    for layer in a.pages:
        for t in layer.values():
            t.copy_(t.new_tensor(rng.standard_normal(t.shape)))
    want = a.read_pages(pids)
    recs = export_request(a, pids, 40)
    assert [r.fill for r in recs] == [16, 16, 8] and a.in_use() == 0
    got = import_request(a, recs, 2)
    assert got is not None and got[1] == 3
    for pid, w in zip(got[0], want):
        for x, y in zip(a.read_page(pid), w):
            assert x.dtype == np.int16
            np.testing.assert_array_equal(x, y)
    for pid in got[0]:
        a.decref(pid)
    dataless = [dataclasses.replace(r, data=None) for r in recs]
    assert import_request(a, dataless, 2) is None
    big = recs * 2                       # 6 pages into 5 usable
    assert import_request(a, big, 2) is None
    assert a.in_use() == 0 and a.audit()
    assert a.stats["import_refused"] == 2


# ------------------------------------------------- against the reference

def _like_page(jpool):
    return jax.tree.map(lambda p: np.asarray(p[:, 0] if p.ndim == 5
                                             else p[0]), jpool.pages)


def test_tickets_agree_with_the_reference_at_every_boundary(cfg, params,
                                                            ref):
    """The reference and the port, the same weights and prompts, frozen
    after the same k ticks: every ticket field agrees exactly, each page
    record's tier/key/fill too, and the page data within one bf16 ulp or
    1e-4 (|a - b| <= max(2**-7 |b|, 1e-4); at most 2% of the values off
    at all: on these weights at most 3 of a page leaf's 2,048)."""
    jcfg, jmodel, jparams = ref
    steps = reference_steps(jmodel)     # compiled once for every k
    kw = dict(num_slots=2, max_len=96, page_size=16,
              prefill_token_budget=16)
    k, phases, n_pages = 0, set(), 0
    while True:
        jb = JBatcher(jcfg, params=jparams, **kw)
        jb._fused_prefill, jb._fused_decode = steps["prefill"], \
            steps["decode"]
        tb = PagedContinuousBatcher(cfg, params=params, device=CPU, **kw)
        for b in (jb, tb):
            for p in PROMPTS:
                b.submit(p, max_new_tokens=5, trust_tier=2)
            for _ in range(k):
                b.tick()
        like = _like_page(jb.pool)
        pairs = [(jb.freeze_request(r), tb.freeze_request(r))
                 for r in range(len(PROMPTS))]
        for jt, tt in pairs:
            assert (jt is None) == (tt is None), k
            if jt is None:
                continue
            phases.add(tt.phase)
            tt = bridge.ticket_to_reference(cfg, tt, page_like=like)
            for f in ("prompt", "prompt_ids", "generated", "max_new",
                      "tier", "kv_tokens", "page_size", "phase"):
                assert getattr(tt, f) == getattr(jt, f), (k, f)
            assert len(tt.pages) == len(jt.pages)
            for jp, tp in zip(jt.pages, tt.pages):
                assert (tp.tier, tp.key, tp.fill) == (jp.tier, jp.key,
                                                      jp.fill)
                for jl, tl in zip(jp.data, tp.data):
                    assert tl.shape == jl.shape and tl.dtype == jl.dtype
                    a = tl.astype(np.float32)
                    b = jl.astype(np.float32)
                    off = np.abs(a - b) > np.maximum(
                        2.0 ** -7 * np.abs(b), 1e-4)
                    assert not off.any(), (k, np.abs(a - b).max())
                    assert (a != b).mean() <= 0.02
                n_pages += 1
        if all(jt is None for jt, _ in pairs):
            break
        k += 1
    assert k > 3 and phases >= {"queued", "prefill", "decode"}
    assert n_pages > 0


def test_reference_pages_import_into_the_port(cfg, params, ref):
    """A page set the reference exported mid-decode, carried across with
    ``bridge.page_data_from_reference`` and imported into a port pool,
    decodes to the reference's own continuation (margin rule)."""
    jcfg, jmodel, jparams = ref
    steps = reference_steps(jmodel)
    kw = dict(num_slots=2, max_len=96, page_size=16)
    j0 = JBatcher(jcfg, params=jparams, fused=True, **kw)
    jtok, jmargin = capture_reference(j0, steps)
    for p in PROMPTS:
        j0.submit(p, max_new_tokens=8, trust_tier=2)
    j0.run_until_done()
    ja = JBatcher(jcfg, params=jparams, **kw)
    ja._fused_prefill, ja._fused_decode = steps["prefill"], steps["decode"]
    rids = [ja.submit(p, max_new_tokens=8, trust_tier=2) for p in PROMPTS]
    for _ in range(4):
        ja.tick()
    like = _like_page(ja.pool)
    tb = PagedContinuousBatcher(cfg, params=params, device=CPU, **kw)
    ttok = capture_port(tb)
    back = {}
    for rid in rids:
        jt = ja.freeze_request(rid)
        assert jt.phase == "decode" and jt.pages
        pages = [PageRecord(tier=r.tier, key=r.key, fill=r.fill,
                            data=bridge.page_data_from_reference(
                                cfg, r.data, like)) for r in jt.pages]
        t = MigrationTicket(
            rid=jt.rid, prompt=jt.prompt, prompt_ids=list(jt.prompt_ids),
            generated=list(jt.generated), max_new=jt.max_new, tier=jt.tier,
            kv_tokens=jt.kv_tokens, page_size=jt.page_size, pages=pages,
            phase=jt.phase)
        back[tb.submit_ticket(t)] = rid
    tb.run_until_done()
    assert tb.migration_stats["imports"] == len(rids)
    assert tb.pool.stats["imported_pages"] > 0
    port = {back[r]: toks for r, toks in ttok.items()}
    assert_streams_match(jtok, jmargin, port)
    assert tb.pool.audit() and tb.pool.in_use() == 0
