"""SLO classes, class-aware scheduling and tenant fairness on the port,
held to the reference over the trace harness.

The scenarios of tests/test_trace_harness.py (all but the ``slow`` 10k
stream) run on the port on the CPU (smollm-135m ``.reduced()``, the
reference's weights moved across by ``repro_torch.bridge``), each
asserting the reference test's claims. Wherever a scenario drives a
mesh, the reference runs the same trace and the port must give exactly
its ``slo_report()`` rows, ``tenant_service``, Jain indices, expired and
shed counts, ticks and mesh work clock (generation has no EOS and no
event reads a token value, so scheduling does not depend on the streams,
which are held under the margin rule of ``_torch_parity`` all the same).

The reference's 1k-request SLO-aware-vs-blind A/B (``slow``) runs here
on a 150-request cut of the same trace, with the reference test's own
claims (interactive TTFT attainment at least 0.80 with SLO awareness and
at least 0.15 above the blind arm), both arms in both packages, rows
equal.
"""
from __future__ import annotations

import math

import jax
import pytest

from _torch_parity import (assert_streams_match, capture_port,
                           capture_reference, lean_cpu,  # noqa: F401
                           reference_steps)
from repro.configs.base import get_config as jget_config
from repro.core import tracegen as jtracegen
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
from repro.obs.metrics import jain_index as jjain
from repro.serving.degrade import slo_rank_map as jrank_map
from repro.serving.engine import TickOrchestrator as JOrch
from repro.serving.engine import build_island_batchers as jbuild
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.core import tracegen
from repro_torch.core.islands import IslandRegistry, personal_island
from repro_torch.core.lighthouse import Lighthouse
from repro_torch.core.mist import MIST
from repro_torch.core.tide import SLO_LAG_TOKENS_PER_UNIT, TIDE
from repro_torch.core.tracegen import SLOClass
from repro_torch.core.waves import WAVES, Policy, Request
from repro_torch.obs import Tracer
from repro_torch.obs.metrics import collect_orchestrator_metrics, jain_index
from repro_torch.serving.degrade import slo_rank_map
from repro_torch.serving.engine import (PendingRequest, TickOrchestrator,
                                        build_island_batchers)

CPU = "cpu"
# the reference test's classes, as (name, deadline_ms, ttft target, tpot
# target, priority), built in either package
CLASS_ROWS = (("interactive", 2400.0, 256.0, 64.0, "primary"),
              ("standard", 5000.0, 768.0, 128.0, "secondary"),
              ("batch", math.inf, math.inf, math.inf, "burstable"))
WEIGHTS = (0.3, 0.45, 0.25)
AB_N = 150

# one torch thread and the reference's step functions shared by every
# batcher of a config (``_torch_parity.lean_cpu``)
pytestmark = pytest.mark.usefixtures("lean_cpu")

PORT = dict(reg=IslandRegistry, island=personal_island, mist=MIST,
            tide=TIDE, lh=Lighthouse, waves=WAVES, policy=Policy,
            build=build_island_batchers, orch=TickOrchestrator,
            tracer=Tracer, tg=tracegen, R=Request, kw={"device": CPU})
REF = dict(reg=JRegistry, island=jpersonal, mist=JMIST, tide=JTIDE,
           lh=JLighthouse, waves=JWAVES, policy=JPolicy, build=jbuild,
           orch=JOrch, tracer=JTracer, tg=jtracegen, R=JRequest, kw={})


def classes(pkg):
    return {n: pkg["tg"].SLOClass(n, deadline_ms=d, ttft_work_target=t,
                                  tpot_work_target=p, priority=pr)
            for n, d, t, p, pr in CLASS_ROWS}


def spec(pkg, n, seed):
    cls = classes(pkg)
    return pkg["tg"].TraceSpec(
        n_requests=n, seed=seed,
        classes=tuple((cls[name], w)
                      for (name, *_), w in zip(CLASS_ROWS, WEIGHTS)),
        arrivals=pkg["tg"].ArrivalSpec(base_rate=4.0))


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


def _mesh(pkg, cfg, params, *, islands=3, slo_aware=True, class_aware=True,
          fair_tenancy=False, decode_ticks=4, tracer=None):
    """tests/test_trace_harness.py's mesh, from ``pkg``'s modules."""
    reg = pkg["reg"]()
    for i in range(islands):
        iid = f"isl{i}"
        reg.register(pkg["island"](iid, latency_ms=120 + 30 * i,
                                   capacity_units=2.0),
                     reg.attestation_token(iid))
    tide = pkg["tide"](reg)
    lh = pkg["lh"](reg)
    for i in reg.all():
        lh.heartbeat(i.island_id)
    waves = pkg["waves"](pkg["mist"](), tide, lh,
                         pkg["policy"](on_infeasible="queue_local"))
    bats = pkg["build"](cfg, reg, cache="paged", max_len=96,
                        slots_per_capacity_unit=2.0, params=params,
                        class_aware=class_aware, **pkg["kw"])
    return pkg["orch"](waves, reg, bats, decode_ticks_per_tick=decode_ticks,
                       slo_classes=classes(pkg), slo_aware=slo_aware,
                       fair_tenancy=fair_tenancy, tracer=tracer,
                       **pkg["kw"])


def stream_both(cfg, params, ref, n, seed, **mesh_kw):
    """Stream the same seeded trace through a port mesh and a reference
    mesh (each with a tracer), capture the batchers' streams, and hold
    the port to the reference: every resolved rid, the SLO rows, tenant
    service, Jain indices, counters, ticks and mesh work clock equal, the
    streams under the margin rule. Returns the port's (orch, rids,
    tracer)."""
    jcfg, jparams, steps = ref
    out = {}
    for name, pkg, c, p in (("port", PORT, cfg, params),
                            ("ref", REF, jcfg, jparams)):
        tracer = pkg["tracer"]()
        orch = _mesh(pkg, c, p, tracer=tracer, **mesh_kw)
        caps = {iid: (capture_port(b) if name == "port"
                      else capture_reference(b, steps))
                for iid, b in orch.batchers.items()}
        rids = pkg["tg"].stream_trace(
            orch, pkg["tg"].generate_trace(spec(pkg, n, seed)))
        out[name] = (orch, rids, tracer, caps)
    (po, pr, ptr, pcaps), (jo, jr, jtr, jcaps) = out["port"], out["ref"]
    assert pr == jr
    assert {r: v is None for r, v in po.results.items()} == \
        {r: v is None for r, v in jo.results.items()}
    assert po.slo_report() == jo.slo_report()
    assert po.tenant_service == jo.tenant_service
    assert jain_index(po.tenant_service.values()) == \
        jjain(jo.tenant_service.values())
    for k in ("ticks", "expired", "shed", "routed", "decode_ticks",
              "fairness_min_jain", "hedges", "migrations_started"):
        assert po.tick_stats[k] == jo.tick_stats[k], k
    assert po.mesh_work == jo.mesh_work
    assert ptr.terminal_counts() == jtr.terminal_counts()
    for iid, ptok in pcaps.items():
        jtok, jmargins = jcaps[iid]
        assert_streams_match(jtok, jmargins, ptok)
    return po, pr, ptr


# ------------------------------------------------------------- unit layer

def test_slo_rank_map_orders_by_ttft_target():
    ranks = slo_rank_map(classes(PORT).values())
    assert ranks["interactive"] > ranks["standard"] > ranks["batch"] == 0
    assert ranks == jrank_map(classes(REF).values())


def test_slo_rank_map_ties_break_by_name():
    a = SLOClass("a", ttft_work_target=100.0)
    b = SLOClass("b", ttft_work_target=100.0)
    assert slo_rank_map([b, a]) == slo_rank_map([a, b]) == {"a": 1, "b": 2}


def test_jain_index_known_values():
    assert jain_index([5, 5, 5]) == pytest.approx(1.0)
    assert jain_index([1, 0, 0]) == pytest.approx(1 / 3)
    assert jain_index([]) == 1.0
    assert jain_index([0, 0]) == 1.0


def test_tide_slo_lag_raises_effective_latency():
    reg = IslandRegistry()
    isl = personal_island("a", latency_ms=100, capacity_units=2.0)
    reg.register(isl, reg.attestation_token("a"))
    tide = TIDE(reg)
    base = tide.effective_latency_ms(isl)
    tide.report_slo_lag("a", 4.0 * SLO_LAG_TOKENS_PER_UNIT)
    assert tide.effective_latency_ms(isl) > base
    tide2 = TIDE(reg)
    tide2.report_slo_lag("a", 0.0)
    tide2.report_slo_lag("a", -5.0)
    tide2.report_slo_lag("ghost", 100.0)
    assert tide2.effective_latency_ms(isl) == pytest.approx(base)


def _pend(rid, user):
    return PendingRequest(rid, Request(query=f"q{rid}", user=user), 4, 0.0)


def test_fair_order_interleaves_tenants():
    orch = TickOrchestrator.__new__(TickOrchestrator)
    orch.tenant_service = {}
    pool = [_pend(0, "a"), _pend(1, "a"), _pend(2, "a"),
            _pend(3, "b"), _pend(4, "b"), _pend(5, "c")]
    orch._fair_order(pool)
    assert [p.req.user for p in pool] == ["a", "b", "c", "a", "b", "a"]


def test_fair_order_prefers_least_served_tenant():
    orch = TickOrchestrator.__new__(TickOrchestrator)
    orch.tenant_service = {"a": 500, "b": 10}
    pool = [_pend(0, "a"), _pend(1, "b")]
    orch._fair_order(pool)
    assert [p.req.user for p in pool] == ["b", "a"]


def test_submit_inherits_class_deadline(cfg, params):
    orch = _mesh(PORT, cfg, params, islands=1)
    rid = orch.submit(Request(query="hello there", slo_class="interactive",
                              sensitivity_override=0.9))
    p = next(p for p in orch.pending if p.rid == rid)
    assert p.deadline_work == orch.mesh_work + 2400.0
    rid2 = orch.submit(Request(query="own deadline", deadline_ms=100.0,
                               slo_class="interactive",
                               sensitivity_override=0.9))
    p2 = next(p for p in orch.pending if p.rid == rid2)
    assert p2.deadline_work == orch.mesh_work + 100.0
    rid3 = orch.submit(Request(query="no deadline", slo_class="batch",
                               sensitivity_override=0.9))
    p3 = next(p for p in orch.pending if p.rid == rid3)
    assert math.isinf(p3.deadline_work)


def test_class_aware_queue_pick_prefers_urgent(cfg, params):
    orch = _mesh(PORT, cfg, params, islands=1)
    b = next(iter(orch.batchers.values()))
    assert b.class_aware
    ra = b.submit("low urgency aaaa", 2, slo_rank=1)
    b.submit("low urgency bbbb", 2, slo_rank=1)
    rc = b.submit("high urgency cccc", 2, slo_rank=2)
    qi = b._queue_pick()
    assert b.queue[qi][0] == rc
    b.queue.pop(qi)
    assert b.queue[b._queue_pick()][0] == ra
    b.queue.clear()
    assert b._queue_pick() is None


def test_rank_blind_batcher_stays_fcfs(cfg, params):
    orch = _mesh(PORT, cfg, params, islands=1, class_aware=False)
    b = next(iter(orch.batchers.values()))
    b.submit("first in line aaaa", 2, slo_rank=1)
    b.submit("second in line bbb", 2, slo_rank=3)
    assert b._queue_pick() == 0


def test_class_aware_chunk_order_and_victim(cfg, params, ref):
    """Class-aware prefill serves the high-rank prompt's chunk first
    under a one-chunk budget where round-robin would serve the low-rank
    one, and on an oversubscribed pool the preemption victim is never the
    high-rank request; chunk order, preemptions and request logs equal
    the reference's, ranked and unranked."""
    from repro.serving.batcher import PagedContinuousBatcher as JBatcher
    from repro_torch.serving.batcher import PagedContinuousBatcher
    jcfg, jparams, _steps = ref
    makers = (lambda **kw: PagedContinuousBatcher(cfg, params=params,
                                                  device=CPU, **kw),
              lambda **kw: JBatcher(jcfg, params=jparams, **kw))
    for class_aware in (False, True):
        # chunk order: both admitted FCFS (low in slot 0), then ranked
        runs = []
        for make in makers:
            b = make(num_slots=2, max_len=96, page_size=16,
                     prefill_token_budget=16)
            low = b.submit("low rank prompt spanning three chunks", 4,
                           trust_tier=1, slo_rank=0)
            high = b.submit("high rank prompt spanning three chunks", 4,
                            trust_tier=2, slo_rank=2)
            b._admit()
            b.class_aware = class_aware
            b._prefill_tick()
            runs.append([b.slots[si].request_id for si in range(2)
                         if b.slots[si].next_chunk])
        assert runs[0] == runs[1] == [high if class_aware else low]
        # the victim: two one-chunk prompts whose decodes outgrow 5 pages
        runs = []
        for make in makers:
            b = make(num_slots=2, max_len=96, page_size=16, num_pages=6,
                     class_aware=class_aware)
            low = b.submit("low rank", 40, trust_tier=1, slo_rank=0)
            high = b.submit("high rank", 40, trust_tier=2, slo_rank=2)
            b.run_until_done()
            assert all(b.request_log[r]["outcome"] == "completed"
                       for r in (low, high))
            runs.append((list(b.preempted_rids), b.request_log))
        assert runs[0] == runs[1]
        preempted = runs[0][0]
        assert preempted
        if class_aware:
            assert high not in preempted


# ----------------------------------------------------------- smoke layer

def test_smoke_trace_slo_classes(cfg, params, ref):
    """A 100-request trace streams to completion on the port, the class
    ladder shows in the work-clock TTFT ordering, and every number is the
    reference's."""
    orch, rids, tracer = stream_both(cfg, params, ref, 100, 3, islands=2,
                                     fair_tenancy=True)
    assert all(r in orch.results for r in rids)
    assert tracer.terminals_exactly_once(rids)
    slo = orch.slo_report()
    assert sum(row["completed"] + row["expired"] + row["shed"]
               + row["rejected"] for row in slo.values()) == 100
    assert slo["interactive"]["completed"] > 0
    assert (slo["interactive"]["ttft_work_p50"]
            < slo["batch"]["ttft_work_p50"])
    snap = collect_orchestrator_metrics(orch).snapshot()
    assert snap["counters"]["completed[interactive]"] \
        == slo["interactive"]["completed"]
    assert snap["counters"]["tenants"] == len(orch.tenant_service)
    stats = orch.stats()
    assert "slo" in stats and "tenant_service" in stats


def test_tenant_fairness_jain_bound(cfg, params, ref):
    """Controlled contention: fair tenancy holds Jain >= 0.9 at a mid-run
    horizon, the FCFS control lands below 0.8, and both runs' tenant
    service equals the reference's."""
    def run(pkg, c, p, fair):
        orch = _mesh(pkg, c, p, slo_aware=False, class_aware=False,
                     fair_tenancy=fair)
        for t in range(3):
            for i in range(32):
                orch.submit(pkg["R"](query=f"tenant t{t} job {i:03d} "
                                     + "x" * 16, user=f"t{t}",
                                     sensitivity_override=0.9),
                            max_new_tokens=4)
        for _ in range(4):
            orch.tick()
        return {f"t{t}": orch.tenant_service.get(f"t{t}", 0)
                for t in range(3)}

    jcfg, jparams, _steps = ref
    for fair in (True, False):
        got = run(PORT, cfg, params, fair)
        assert got == run(REF, jcfg, jparams, fair)
        j = jain_index(got.values())
        assert (j >= 0.9) if fair else (j < 0.8)


def test_slo_aware_vs_blind_ab(cfg, params, ref):
    """The A/B of the reference's slow 1k test on a 150-request cut of
    its trace: each arm's rows, ticks and work clock are the reference's,
    nothing is stranded, and SLO awareness lifts the interactive class's
    TTFT attainment as the reference test requires."""
    att = {}
    for on in (True, False):
        orch, rids, tracer = stream_both(cfg, params, ref, AB_N, 0,
                                         slo_aware=on, class_aware=on)
        assert all(r in orch.results for r in rids)
        assert tracer.terminals_exactly_once(rids)
        att[on] = orch.slo_report()["interactive"].get("ttft_attainment",
                                                       0.0)
    assert att[True] - att[False] >= 0.15, att
    assert att[True] >= 0.80, att
