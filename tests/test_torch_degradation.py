"""The port's graceful-degradation layer, held to the reference's.

The scenarios of tests/test_degradation.py (all but the two per-tier
quota cases, which tests/test_torch_privacy_sched.py holds) run through both packages' ``TickOrchestrator`` on the CPU
(smollm-135m ``.reduced()``, the reference's weights moved across by
``repro_torch.bridge``, a ``Tracer`` and ``debug_audit`` on both), and
each test asserts the reference test's claims on the port and then
holds the port's run to the reference's:

* the span journals, event for event, on (kind, island, rid, tick, work)
  and every attribute but the router's ``score``, which both sides round
  to 4 decimals from a float32 sum that XLA and torch order differently
  (held within 1e-3, where a one-step rounding difference lands);
* which rids resolved and which to None (expired, shed, bounced, rejected
  or executor-rejected), the typed reject reasons in order, and the
  orchestrator's counters (expired, shed, backpressure bounces, hedges,
  failovers, migrations, returns, ticks) and mesh work clock;
* every completed text where the two streams agree under the margin rule
  (``_torch_parity``), checked on the batchers' streams.

Two cases are the port's own: a stacked-manager ``cancel_request`` and
``set_slowdown`` (the reference's scenarios are all paged), and an
admission into a slot whose fused decode was cancelled mid-stream.
"""
import jax
import pytest

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from _torch_parity import (assert_streams_match, capture_port,
                           capture_reference, reference_steps)
from repro.configs.base import get_config as jget_config
from repro.core.islands import IslandRegistry as JRegistry
from repro.core.islands import personal_island as jpersonal
from repro.core.lighthouse import Lighthouse as JLighthouse
from repro.core.mist import MIST as JMIST
from repro.core.tide import TIDE as JTIDE
from repro.core.waves import WAVES as JWAVES
from repro.core.waves import Policy as JPolicy
from repro.core.waves import Request as JRequest
from repro.models.model import get_model as jget_model
from repro.obs import Tracer as JTracer
from repro.serving.degrade import FaultEvent as JFaultEvent
from repro.serving.degrade import FaultPlan as JFaultPlan
from repro.serving.degrade import OverloadPolicy as JOverload
from repro.serving.degrade import RejectReason as JRejectReason
from repro.serving.engine import TickOrchestrator as JOrch
from repro.serving.engine import build_island_batchers as jbuild
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.core.islands import IslandRegistry, personal_island
from repro_torch.core.lighthouse import Lighthouse
from repro_torch.core.mist import MIST
from repro_torch.core.tide import TIDE
from repro_torch.core.waves import WAVES, Policy, Request
from repro_torch.obs import Tracer
from repro_torch.serving.batcher import (ContinuousBatcher,
                                         PagedContinuousBatcher,
                                         make_batcher)
from repro_torch.serving.degrade import (FaultEvent, FaultPlan,
                                         OverloadPolicy, RejectReason)
from repro_torch.serving.engine import TickOrchestrator, build_island_batchers

# one torch thread, and the reference's step functions shared by
# every batcher of a config (``_torch_parity.lean_cpu``)
pytestmark = pytest.mark.usefixtures("lean_cpu")

CPU = "cpu"
SCORE_TOL = 1e-3
COUNTERS = ("ticks", "routed", "expired", "shed", "backpressure_rejects",
            "hedges", "failovers", "migrations_started", "migrations",
            "recomputes", "migration_returns", "restarts", "decode_ticks",
            "device_dispatches", "islands_drained")

PORT = dict(reg=IslandRegistry, island=personal_island, mist=MIST,
            tide=TIDE, lh=Lighthouse, waves=WAVES, policy=Policy,
            build=build_island_batchers, orch=TickOrchestrator,
            tracer=Tracer, overload=OverloadPolicy, R=Request,
            plan=FaultPlan, event=FaultEvent, reason=RejectReason,
            kw={"device": CPU})
REF = dict(reg=JRegistry, island=jpersonal, mist=JMIST, tide=JTIDE,
           lh=JLighthouse, waves=JWAVES, policy=JPolicy, build=jbuild,
           orch=JOrch, tracer=JTracer, overload=JOverload, R=JRequest,
           plan=JFaultPlan, event=JFaultEvent, reason=JRejectReason, kw={})


@pytest.fixture(scope="module")
def ref():
    jcfg = jget_config("smollm-135m").reduced()
    jmodel = jget_model(jcfg)
    return jcfg, jmodel.init(jax.random.PRNGKey(0), "float32"), \
        reference_steps(jmodel)


@pytest.fixture(scope="module")
def cfg():
    return get_config("smollm-135m").reduced()


@pytest.fixture(scope="module")
def params(cfg, ref):
    return bridge.from_reference(cfg, jax.device_get(ref[1]))


def _mesh(pkg, cfg, params, *, islands=(("solo", 20.0),), overload=None,
          straggler_patience=None, prefill_token_budget=None,
          migration_token_budget=512):
    """tests/test_degradation.py's mesh, built from ``pkg``'s modules."""
    reg = pkg["reg"]()
    for iid, lat in islands:
        reg.register(pkg["island"](iid, latency_ms=lat, capacity_units=2.0),
                     reg.attestation_token(iid))
    tide = pkg["tide"](reg, straggler_patience=straggler_patience)
    lh = pkg["lh"](reg)
    for i in reg.all():
        lh.heartbeat(i.island_id)
    waves = pkg["waves"](pkg["mist"](), tide, lh, pkg["policy"]())
    bats = pkg["build"](cfg, reg, cache="paged", max_len=96, params=params,
                        prefill_token_budget=prefill_token_budget,
                        **pkg["kw"])
    tracer = pkg["tracer"]()
    orch = pkg["orch"](waves, reg, bats, decode_ticks_per_tick=1,
                       migration_token_budget=migration_token_budget,
                       overload=overload, debug_audit=True, tracer=tracer,
                       **pkg["kw"])
    return orch, tracer


def journal(tracer):
    out = []
    for e in tracer.events:
        attrs = dict(e.attrs)
        score = attrs.pop("score", None)
        out.append((e.kind, e.island, e.rid, e.tick, e.work, attrs,
                    score is None))
    return out


def scores(tracer):
    return [e.attrs["score"] for e in tracer.events
            if e.attrs.get("score") is not None]


def run_both(cfg, params, ref, script, overload=None, **mesh_kw):
    """Run ``script(orch, tracer, pkg)`` on a port mesh and on a
    reference mesh (``overload`` is a dict of ``OverloadPolicy`` fields),
    capturing every batcher's streams, and hold the port to the
    reference. Returns (port run, reference run), each a dict with
    ``orch``, ``tracer`` and the script's result ``out``."""
    jcfg, jparams, steps = ref
    runs = {}
    for name, pkg, c, p in (("port", PORT, cfg, params),
                            ("ref", REF, jcfg, jparams)):
        ov = pkg["overload"](**overload) if overload is not None else None
        orch, tracer = _mesh(pkg, c, p, overload=ov, **mesh_kw)
        caps = {iid: (capture_port(b) if name == "port"
                      else capture_reference(b, steps))
                for iid, b in orch.batchers.items()}
        out = script(orch, tracer, pkg)
        runs[name] = {"orch": orch, "tracer": tracer, "out": out,
                      "caps": caps}
    hold(runs["port"], runs["ref"])
    return runs["port"], runs["ref"]


def hold(port, refr):
    po, jo = port["orch"], refr["orch"]
    assert journal(port["tracer"]) == journal(refr["tracer"])
    ps, js = scores(port["tracer"]), scores(refr["tracer"])
    assert len(ps) == len(js)
    assert all(abs(a - b) <= SCORE_TOL for a, b in zip(ps, js)), (ps, js)
    assert port["tracer"].terminal_counts() == \
        refr["tracer"].terminal_counts()
    assert sorted(po.results) == sorted(jo.results)
    assert {r for r, v in po.results.items() if v is None} == \
        {r for r, v in jo.results.items() if v is None}
    assert [str(d.reason) for d in po.rejected] == \
        [str(d.reason) for d in jo.rejected]
    for k in COUNTERS:
        assert po.tick_stats[k] == jo.tick_stats[k], k
    assert po.mesh_work == jo.mesh_work
    for iid, ptok in port["caps"].items():
        jtok, jmargins = refr["caps"][iid]
        assert_streams_match(jtok, jmargins, ptok)


def _expire_events(tracer, rid):
    return [e for e in tracer.events
            if e.kind == "expire" and e.rid == rid and e.island is None]


def _assert_expired_once(orch, tracer, rid, stage, reason):
    evs = _expire_events(tracer, rid)
    assert len(evs) == 1
    assert evs[0].attrs["stage"] == stage
    assert orch.results[rid] is None
    assert orch.tick_stats["expired"] == 1
    assert not [e for e in tracer.events
                if e.kind in ("complete", "finish") and e.rid == rid]
    assert tracer.terminals_exactly_once([rid])
    assert any(d.reason == reason.EXPIRED for d in orch.rejected)


# ------------------------------------------- expiry: every lifecycle stage

def test_expire_while_queued(cfg, params, ref):
    def script(orch, tracer, pkg):
        rid = orch.submit(pkg["R"]("queued deadline victim",
                                   priority="primary", deadline_ms=0.0),
                          max_new_tokens=4)
        orch.tick()
        _assert_expired_once(orch, tracer, rid, "queued", pkg["reason"])
        assert not [e for e in tracer.events
                    if e.kind == "route" and e.rid == rid]
        for _ in range(3):
            orch.tick()
        assert orch.tick_stats["expired"] == 1
        return rid

    run_both(cfg, params, ref, script)


def test_expire_mid_chunk_prefill(cfg, params, ref):
    def script(orch, tracer, pkg):
        prompt = ("deadline prefill victim padding " * 4)[:80]
        rid = orch.submit(pkg["R"](prompt, priority="primary",
                                   deadline_ms=60.0), max_new_tokens=8)
        for _ in range(8):
            orch.tick()
            if rid in orch.results:
                break
        _assert_expired_once(orch, tracer, rid, "inflight", pkg["reason"])
        b = orch.batchers["solo"]
        rec = next(r for r in b.request_log.values()
                   if r.get("outcome") == "expired")
        assert "first_token_tick" not in rec
        assert b.pool.audit() and b.pool.in_use() == 0
        assert b.reserved == 0
        return rec

    port, refr = run_both(cfg, params, ref, script,
                          prefill_token_budget=16)
    assert port["out"] == refr["out"]


def test_expire_mid_fused_decode(cfg, params, ref):
    """Budget blown while decoding: the partial output is discarded, the
    expiry is the only terminal, the pool drains clean, the expired slot
    leaves no device-resident tail (``gen_dev`` 0) and its terminal
    counts the tail's tokens as the reference's does."""
    def script(orch, tracer, pkg):
        rid = orch.submit(pkg["R"]("decode victim xx", priority="primary",
                                   deadline_ms=30.0), max_new_tokens=48)
        for _ in range(40):
            orch.tick()
            if rid in orch.results:
                break
        _assert_expired_once(orch, tracer, rid, "inflight", pkg["reason"])
        b = orch.batchers["solo"]
        rec = next(r for r in b.request_log.values()
                   if r.get("outcome") == "expired")
        assert rec["generated_tokens"] > 0
        assert "first_token_tick" in rec
        assert b.pool.audit() and b.pool.in_use() == 0
        assert all(s.gen_dev == 0 and not s.active for s in b.slots)
        return rec

    port, refr = run_both(cfg, params, ref, script)
    assert port["out"] == refr["out"]


def test_admission_after_a_cancelled_fused_decode(cfg, params):
    """A request admitted into the slot a fused decode was cancelled in
    decodes from its own tokens, not the cancelled stream's stale device
    tail: its stream equals the same request's on a fresh batcher."""
    kw = dict(params=params, num_slots=1, max_len=96, page_size=16,
              device=CPU)
    fresh = PagedContinuousBatcher(cfg, **kw)
    r = fresh.submit("follow-up request", max_new_tokens=6, trust_tier=2)
    want = fresh.run_until_done()[r]
    b = PagedContinuousBatcher(cfg, **kw)
    victim = b.submit("decode victim xx", max_new_tokens=48, trust_tier=2)
    for _ in range(6):
        b.tick()
    s = b.slots[0]
    assert s.active and s.gen_dev > 1       # mid fused decode
    assert b.cancel_request(victim)
    assert b.slots[0].gen_dev == 0 and not b.slots[0].active
    assert b.request_log[victim]["outcome"] == "expired"
    assert victim not in b.finished
    r = b.submit("follow-up request", max_new_tokens=6, trust_tier=2)
    assert b.run_until_done()[r] == want
    assert b.pool.audit() and b.pool.in_use() == 0
    assert not b.cancel_request(victim)     # already gone


def test_expire_frozen_in_flight(cfg, params, ref):
    def script(orch, tracer, pkg):
        rid = orch.submit(pkg["R"]("frozen mid-flight deadline victim",
                                   priority="primary", deadline_ms=30.0),
                          max_new_tokens=48)
        for _ in range(40):
            orch.tick()
            if orch.mesh_work >= 30.0 or rid in orch.results:
                break
        assert rid not in orch.results
        orch.drain_island("solo")
        orch.tick()
        _assert_expired_once(orch, tracer, rid, "frozen", pkg["reason"])
        assert _expire_events(tracer, rid)[0].attrs["island"] == "solo"
        assert orch.tick_stats["migrations_started"] == 1
        for _ in range(3):
            orch.tick()
        assert not orch._draining

    run_both(cfg, params, ref, script)


def test_completion_beats_expiry_on_the_same_tick(cfg, params, ref):
    def script(orch, tracer, pkg):
        rid = orch.submit(pkg["R"]("fits inside its budget",
                                   priority="primary", deadline_ms=500.0),
                          max_new_tokens=3)
        for _ in range(30):
            orch.tick()
            if rid in orch.results:
                break
        assert orch.results[rid] is not None
        assert orch.tick_stats["expired"] == 0
        assert not _expire_events(tracer, rid)
        assert tracer.terminals_exactly_once([rid])

    run_both(cfg, params, ref, script)


def test_expiry_feeds_tide_pressure(cfg, params, ref):
    def script(orch, tracer, pkg):
        tide = orch.waves.tide
        before = tide._st("solo").inflight
        rid = orch.submit(pkg["R"]("decode victim yy", priority="primary",
                                   deadline_ms=30.0), max_new_tokens=48)
        for _ in range(40):
            orch.tick()
            if rid in orch.results:
                break
        assert orch.results[rid] is None
        assert tide._st("solo").inflight > before
        return tide._st("solo").inflight

    port, refr = run_both(cfg, params, ref, script)
    assert port["out"] == pytest.approx(refr["out"], rel=1e-12)


# ------------------------------------------------- shedding / backpressure

def test_watermark_shed_drops_newest_lowest_priority(cfg, params, ref):
    def script(orch, tracer, pkg):
        R = pkg["R"]
        keep = orch.submit(R("primary keeper", priority="primary"),
                           max_new_tokens=2)
        shed_rids = [orch.submit(R(f"sheddable {i}", priority="secondary"),
                                 max_new_tokens=2) for i in range(5)]
        orch.tick()
        assert orch.tick_stats["shed"] == 4
        assert shed_rids[0] not in [e.rid for e in tracer.events
                                    if e.kind == "reject"]
        for rid in shed_rids[1:]:
            assert orch.results[rid] is None
        assert keep not in orch.results or orch.results[keep] is not None
        assert {str(d.reason) for d in orch.rejected} == \
            {str(pkg["reason"].SHED)}

    run_both(cfg, params, ref, script, overload=dict(queue_watermark=2))


def test_backpressure_bounces_sheddable_at_submit(cfg, params, ref):
    def script(orch, tracer, pkg):
        R = pkg["R"]
        orch.waves.lighthouse.report_saturation(1.0)
        bounced = orch.submit(R("burstable victim", priority="burstable"),
                              max_new_tokens=2)
        assert orch.results[bounced] is None
        assert orch.tick_stats["backpressure_rejects"] == 1
        assert any(d.reason == pkg["reason"].BACKPRESSURE
                   for d in orch.rejected)
        assert tracer.terminals_exactly_once([bounced])
        vip = orch.submit(R("primary passes", priority="primary"),
                          max_new_tokens=2)
        assert vip not in orch.results

    run_both(cfg, params, ref, script,
             overload=dict(queue_watermark=8, backpressure_pct=100))


def test_stale_telemetry_suppresses_saturation_hint(cfg, params, ref):
    def script(orch, tracer, pkg):
        R = pkg["R"]
        lh = orch.waves.lighthouse
        lh.stale = True
        lh.report_saturation(1.0)
        rid = orch.submit(R("burstable passes while stale",
                            priority="burstable"), max_new_tokens=2)
        assert rid not in orch.results
        lh.stale = False
        lh.report_saturation(1.0)
        rid2 = orch.submit(R("burstable bounced when fresh",
                             priority="burstable"), max_new_tokens=2)
        assert orch.results[rid2] is None

    run_both(cfg, params, ref, script,
             overload=dict(queue_watermark=8, backpressure_pct=100))


# ------------------------------------------- privacy options are accepted

@pytest.mark.parametrize("kw", [dict(tier_quotas={1: 2}),
                                dict(constant_shape=True)])
def test_p10_options_are_accepted(cfg, params, kw):
    """Per-tier quotas and constant-shape dispatch reach the paged batcher
    through every entry point that takes them (``make_batcher``, the
    batcher itself, ``build_island_batchers``), and ``make_batcher`` drops
    them for the stacked manager, as the reference does."""
    name, value = next(iter(kw.items()))
    b = make_batcher(cfg, cache="paged", params=params, num_slots=4,
                     max_len=96, device=CPU, **kw)
    assert isinstance(b, PagedContinuousBatcher)
    assert (b.tier_quotas if name == "tier_quotas"
            else b.constant_shape) == value
    b = PagedContinuousBatcher(cfg, params=params, num_slots=4, max_len=96,
                               device=CPU, **kw)
    assert getattr(b, name) == value
    s = make_batcher(cfg, cache="stacked", params=params, num_slots=4,
                     max_len=96, device=CPU, **kw)
    assert isinstance(s, ContinuousBatcher)
    assert not hasattr(s, name)
    reg = IslandRegistry()
    reg.register(personal_island("solo", latency_ms=20.0,
                                 capacity_units=2.0),
                 reg.attestation_token("solo"))
    bats = build_island_batchers(cfg, reg, cache="paged", max_len=96,
                                 params=params, device=CPU, **kw)
    assert getattr(bats["solo"], name) == value
    # off changes nothing
    b = make_batcher(cfg, cache="paged", params=params, num_slots=2,
                     max_len=96, device=CPU, constant_shape=False,
                     tier_quotas=None)
    assert b.tier_quotas is None and not b.constant_shape


# ------------------------------------------- stragglers, hedging, backoff

def test_straggler_hedge_completes_elsewhere(cfg, params, ref):
    def script(orch, tracer, pkg):
        rids = [orch.submit(pkg["R"](f"hedged request {i} with some "
                                     f"padding", priority="primary"),
                            max_new_tokens=12) for i in range(4)]
        orch.tick()
        loaded = {iid for iid, _ in orch._local_inflight}
        assert loaded
        victim = sorted(loaded)[0]
        orch.batchers[victim].set_slowdown(50)
        for _ in range(60):
            orch.tick()
            if all(r in orch.results for r in rids):
                break
        assert all(orch.results[r] is not None for r in rids)
        assert orch.tick_stats["hedges"] >= 1
        return victim

    port, refr = run_both(cfg, params, ref, script,
                          islands=(("fast", 20.0), ("slow", 20.0)),
                          straggler_patience=2)
    assert port["out"] == refr["out"]


def test_placement_backoff_caps_migration_churn(cfg, params, ref):
    def script(orch, tracer, pkg):
        rid = orch.submit(pkg["R"]("nowhere to go", priority="primary"),
                          max_new_tokens=10)
        orch.tick()
        orch.drain_island("solo")
        for _ in range(10):
            orch.tick()
            if rid in orch.results:
                break
        assert orch.results[rid] is not None
        assert orch.tick_stats["migration_returns"] == 1
        ev = next(e for e in tracer.events if e.kind == "migrate_return")
        assert ev.attrs["attempts"] == 1 and ev.attrs["backoff_ticks"] == 16

    run_both(cfg, params, ref, script)


def test_mesh_work_clock_monotonic_across_failure(cfg, params, ref):
    def script(orch, tracer, pkg):
        for i in range(3):
            orch.submit(pkg["R"](f"pre-failure work {i}",
                                 priority="primary"), max_new_tokens=4)
        for _ in range(3):
            orch.tick()
        clocks = [orch.mesh_work]
        assert clocks[0] > 0
        orch.fail_island(sorted(orch.batchers)[0])
        for _ in range(8):
            orch.tick()
            assert orch.mesh_work >= clocks[-1]
            clocks.append(orch.mesh_work)
        return clocks

    port, refr = run_both(cfg, params, ref, script,
                          islands=(("a", 20.0), ("b", 25.0)))
    assert port["out"] == refr["out"]


# --------------------------------------------- fault plan and vocabulary

def test_fault_plan_applies_in_order(cfg, params, ref):
    def script(orch, tracer, pkg):
        fired = []
        ev = pkg["event"]
        plan = pkg["plan"]([
            ev(tick=0, kind="slowdown", island="solo", factor=3),
            ev(tick=1, kind="telemetry_stale", on=True),
            ev(tick=2, kind="burst", submit=lambda o: fired.append(True)),
            ev(tick=2, kind="telemetry_stale", on=False),
            ev(tick=3, kind="recover", island="solo"),
        ])
        assert not plan.done()
        for t in range(4):
            plan.step(orch)
            if t == 0:
                assert orch.batchers["solo"].slowdown == 3
            if t == 1:
                assert orch.waves.lighthouse.stale
            orch.tick()
        assert orch.batchers["solo"].slowdown == 1
        assert not orch.waves.lighthouse.stale
        assert fired == [True]
        assert plan.done()
        return [k for _t, k, _i in plan.applied]

    port, refr = run_both(cfg, params, ref, script)
    assert port["out"] == refr["out"] == [
        "slowdown", "telemetry_stale", "burst", "telemetry_stale",
        "recover"]


def test_reject_reasons_are_the_references():
    assert RejectReason.SHED == "shed"
    assert str(RejectReason.EXPIRED) == "expired"
    assert isinstance(RejectReason.BACKPRESSURE, str)
    assert {r.value for r in RejectReason} == \
        {r.value for r in JRejectReason}


# ------------------------------------------------- the stacked manager

def test_stacked_cancel_and_slowdown(cfg, params):
    """The stacked manager cancels a queued and an in-slot request (no
    terminal in ``finished``, an ``expire`` span each), and a slowed
    stacked batcher produces the full-speed streams on a work clock that
    is the same, over ``factor`` times the ticks; skipped ticks dispatch
    nothing."""
    kw = dict(params=params, num_slots=1, max_len=96, device=CPU)
    tr = Tracer()
    b = ContinuousBatcher(cfg, **kw)
    b.attach_tracer(tr, island="s")
    live = b.submit("stacked cancel victim", max_new_tokens=20)
    queued = b.submit("queued behind it", max_new_tokens=4)
    b.tick()
    b.tick()
    assert b.slots[0].active and len(b.queue) == 1
    assert b.cancel_request(queued) and b.cancel_request(live)
    assert not b.busy() and not b.finished
    assert [(e.rid, e.attrs["tokens"]) for e in tr.by_kind("expire")] == \
        [(queued, 0), (live, 3)]
    assert not b.cancel_request(live)
    assert tr.conservation_ok({"s": b})["all"]

    prompts = ["slow stacked request one", "slow stacked request two"]
    runs = []
    for factor in (1, 3):
        b = ContinuousBatcher(cfg, **kw)
        b.set_slowdown(factor)
        rids = [b.submit(p, max_new_tokens=5) for p in prompts]
        dispatches = []
        while b.busy():
            d0 = b.stats["device_dispatches"]
            b.tick()
            dispatches.append(b.stats["device_dispatches"] - d0)
        runs.append(([b.finished[r] for r in rids], b.work_clock,
                     b.stats["ticks"], dispatches))
    (s1, w1, t1, d1), (s3, w3, t3, d3) = runs
    assert s3 == s1 and w3 == w1
    assert t3 == 3 * t1 - 2           # the last real tick ends the run
    assert [d for k, d in enumerate(d3) if k % 3 != 0] == \
        [0] * (len(d3) - len(d1))
    assert [d for k, d in enumerate(d3) if k % 3 == 0] == d1


def test_slowed_fused_batcher_skips_without_touching_the_device(cfg,
                                                                 params):
    """A skipped tick of a slowed fused paged batcher plans, launches and
    reads back nothing (no dispatch, no materialized tail), and the
    streams equal the full-speed run's."""
    kw = dict(params=params, num_slots=2, max_len=96, page_size=16,
              device=CPU)
    prompts = ["fused slow one with a longer prompt", "fused slow two"]
    base = PagedContinuousBatcher(cfg, **kw)
    rids = [base.submit(p, max_new_tokens=6, trust_tier=2) for p in prompts]
    want = [base.run_until_done()[r] for r in rids]
    b = PagedContinuousBatcher(cfg, **kw)
    b.set_slowdown(4)
    rids = [b.submit(p, max_new_tokens=6, trust_tier=2) for p in prompts]
    reads = []
    materialize = b._materialize_slot
    b._materialize_slot = lambda si: (reads.append(b.stats["ticks"]),
                                      materialize(si))
    skipped = 0
    while b.busy():
        d0, t0 = b.stats["device_dispatches"], b.stats["ticks"]
        tails = [s.gen_dev for s in b.slots]
        b.tick()
        if b._slow_phase != 1:
            skipped += 1
            assert b.stats["device_dispatches"] == d0
            assert [s.gen_dev for s in b.slots] == tails
            assert t0 + 1 not in reads
    assert skipped > 0
    assert [b.finished[r] for r in rids] == want
