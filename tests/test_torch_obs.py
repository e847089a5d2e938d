"""The port's observability layer, held to the reference's.

The scenarios of tests/test_obs.py run through both packages on the CPU
(smollm-135m ``.reduced()``, the reference's seeded weights moved across
by ``repro_torch.bridge``), and the port must give:

* the same span journal, event for event, on (kind, island, rid, tick,
  work) and every attribute (never ``wall_ns``, the profiling-only
  clock). No event carries a token value, and greedy scheduling does not
  depend on token values, so the journals agree exactly even where a
  near-tie lets two streams part;
* the same ``work_by_island``, ``conservation_ok``, ``terminal_counts``,
  ``first_token_counts``, request logs, ``collect_batcher_metrics``
  snapshot, ``ttft_stats``, hardened ``tenant_summary`` and Chrome-trace
  layout (every field but the wall-clock ``ts``);
* the same ``DispatchProfiler`` ticks, dispatches, ``unique_shapes`` and
  ``shape_dispatches`` (its nanoseconds are never compared);
* the same token streams under the margin rule of ``_torch_parity``.

Attaching a tracer and a profiler to the port changes nothing it
computes: streams, work clock and dispatch counts are equal with and
without them (exactly: both runs are the port on the CPU).
"""
import json

import jax
import pytest
import torch

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from _torch_parity import (assert_streams_match, capture_port,
                           capture_reference, reference_steps)
from repro.configs.base import get_config as jget_config
from repro.core.lighthouse import TelemetryPolicy as JTelemetryPolicy
from repro.models.model import get_model as jget_model
from repro.obs import DispatchProfiler as JProfiler
from repro.obs import Tracer as JTracer
from repro.obs import collect_batcher_metrics as jcollect
from repro.obs import ttft_stats as jttft_stats
from repro.obs import write_chrome_trace as jwrite
from repro.serving.batcher import PagedContinuousBatcher as JBatcher
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.core.lighthouse import TelemetryPolicy
from repro_torch.obs import (DispatchProfiler, Tracer,
                             collect_batcher_metrics, ttft_stats,
                             write_chrome_trace)
from repro_torch.obs.profile import _first_tensor
from repro_torch.serving.batcher import PagedContinuousBatcher

# one torch thread, and the reference's step functions shared by
# every batcher of a config (``_torch_parity.lean_cpu``)
pytestmark = pytest.mark.usefixtures("lean_cpu")

CPU = "cpu"
PREFIX = "shared observability preamble for the span tests. "
WL = [
    (PREFIX + "alpha " * 6, 6, 1),
    (PREFIX + "beta " * 3, 5, 1),
    ("an unrelated billing question about invoices", 6, 2),
    ("tiny", 4, None),
]
PROFILE_KEYS = ("ticks", "dispatches", "unique_shapes", "shape_dispatches")


@pytest.fixture(scope="module")
def ref():
    jcfg = jget_config("smollm-135m").reduced()
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), "float32")
    return jcfg, jparams, reference_steps(jmodel)


@pytest.fixture(scope="module")
def cfg():
    return get_config("smollm-135m").reduced()


@pytest.fixture(scope="module")
def params(cfg, ref):
    return bridge.from_reference(cfg, jax.device_get(ref[1]))


def journal(tracer):
    """The deterministic view of a journal: every field but ``wall_ns``
    (``seq`` is the emission order, which the list order already is)."""
    return [(e.kind, e.island, e.rid, e.tick, e.work, e.attrs)
            for e in tracer.events]


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("num_slots", 3)
    kw.setdefault("max_len", 96)
    kw.setdefault("page_size", 16)
    return kw


def _drive(b, traced, workload):
    tr = None
    if traced:
        tr = traced()
        b.attach_tracer(tr, island="isl")
        b.profiler = (DispatchProfiler if isinstance(tr, Tracer)
                      else JProfiler)()
    rids = [b.submit(p, max_new_tokens=mn, trust_tier=t)
            for p, mn, t in workload]
    done = b.run_until_done()
    return {"b": b, "tr": tr, "rids": rids,
            "streams": [done[r] for r in rids]}


def drive_port(cfg, params, traced, workload=WL, **kw):
    b = PagedContinuousBatcher(cfg, params=params, fused=True, device=CPU,
                               **_kw(kw))
    tokens = capture_port(b)
    out = _drive(b, Tracer if traced else None, workload)
    out["tokens"] = tokens
    return out


def drive_ref(ref, workload=WL, **kw):
    jcfg, jparams, steps = ref
    b = JBatcher(jcfg, params=jparams, fused=True, **_kw(kw))
    tokens, margins = capture_reference(b, steps)
    out = _drive(b, JTracer, workload)
    out["tokens"], out["margins"] = tokens, margins
    return out


@pytest.fixture(scope="module")
def ab(cfg, params, ref):
    """The port untraced and traced, and the reference traced, on the
    same workload (shared by the tests below)."""
    return (drive_port(cfg, params, False), drive_port(cfg, params, True),
            drive_ref(ref))


def assert_same_trace(port, refr):
    """The port's run against the reference's: journals, per-island work,
    terminals, first tokens and request logs equal; streams under the
    margin rule."""
    assert journal(port["tr"]) == journal(refr["tr"])
    assert port["tr"].work_by_island() == refr["tr"].work_by_island()
    assert port["tr"].terminal_counts() == refr["tr"].terminal_counts()
    assert port["tr"].first_token_counts() == \
        refr["tr"].first_token_counts()
    assert port["b"].request_log == refr["b"].request_log
    assert port["b"].work_clock == refr["b"].work_clock
    assert port["b"].dispatch_shapes == refr["b"].dispatch_shapes
    assert_streams_match(refr["tokens"], refr["margins"], port["tokens"])


# ------------------------------------------------- zero interference

def test_tracing_zero_interference(ab):
    off, on, _ref = ab
    assert on["streams"] == off["streams"]
    assert on["b"].work_clock == off["b"].work_clock
    assert on["b"].stats["device_dispatches"] == \
        off["b"].stats["device_dispatches"]
    assert on["b"].request_log == off["b"].request_log


def test_journal_matches_reference(ab):
    _off, on, refr = ab
    assert len(on["tr"]) > 0
    assert_same_trace(on, refr)
    assert {e.kind for e in on["tr"].events} >= {
        "queue", "admit", "prefill", "first_token", "decode", "finish",
        "page_alloc", "page_share"}


def test_span_work_conservation(ab):
    _off, on, refr = ab
    tr = on["tr"]
    cons = tr.conservation_ok({"isl": on["b"]})
    assert cons == {"isl": True, "all": True}
    assert cons == refr["tr"].conservation_ok({"isl": refr["b"]})
    per = tr.work_by_island()["isl"]
    assert sum(per.values()) == on["b"].work_clock
    assert set(per) == set(on["rids"])


def test_first_token_and_terminals(ab):
    _off, on, _ref = ab
    tr, b = on["tr"], on["b"]
    assert all(v == 1 for v in tr.first_token_counts().values())
    assert len(tr.first_token_counts()) == len(on["rids"])
    assert len(tr.by_kind("finish")) == len(on["rids"])
    for rid in on["rids"]:
        rec = b.request_log[rid]
        assert rec["outcome"] == "completed"
        assert "done_tick" in rec and "done_work" in rec
        assert rec["generated_tokens"] > 0


def test_pool_events_traced(ab):
    _off, on, refr = ab
    for kind in ("page_alloc", "page_share", "page_cow"):
        assert len(on["tr"].by_kind(kind)) == \
            len(refr["tr"].by_kind(kind)), kind
    assert len(on["tr"].by_kind("page_alloc")) > 0
    assert len(on["tr"].by_kind("page_share")) > 0


def test_no_event_attribute_is_a_tensor(ab):
    """Tracing reads nothing from the device: every attribute is a host
    value (rids, slots, counts), never a tensor or a token."""
    _off, on, _ref = ab

    def host(v):
        if isinstance(v, (list, tuple)):
            return all(host(x) for x in v)
        if isinstance(v, dict):
            return all(host(x) for x in v.values())
        return not isinstance(v, torch.Tensor)

    assert all(host(e.attrs) for e in on["tr"].events)


def test_collect_batcher_metrics(ab):
    _off, on, refr = ab
    snap = collect_batcher_metrics(on["b"]).snapshot()
    assert snap == jcollect(refr["b"]).snapshot()
    assert snap["counters"]["requests"] == len(on["rids"])
    assert snap["histograms"]["ttft_work"]["n"] == len(on["rids"])
    assert snap["histograms"]["tpot_work"]["min"] >= 1.0


def test_ttft_stats_delegation(ab):
    _off, on, refr = ab
    b = on["b"]
    assert ttft_stats(b.request_log) == jttft_stats(refr["b"].request_log)
    sub = ttft_stats(b.request_log, rids=on["rids"][:2])
    assert sub == jttft_stats(refr["b"].request_log, rids=on["rids"][:2])
    assert ttft_stats({}) == {}


# ------------------------------------------- lifecycle under churn

def test_ttft_once_and_terminals_under_preemption(cfg, params, ref):
    """Pool-exhaustion preemption: TTFT recorded once per request, every
    rid terminal, one ``preempt`` event per preemption, and the journal
    the reference's."""
    wl = [(f"tiny seed {i}", 40, i % 2) for i in range(4)]
    out = drive_port(cfg, params, True, workload=wl, num_pages=6)
    refr = drive_ref(ref, workload=wl, num_pages=6)
    b, tr = out["b"], out["tr"]
    assert b.stats["preemptions"] > 0
    assert b.stats["preemptions"] == refr["b"].stats["preemptions"]
    assert len(tr.by_kind("preempt")) == b.stats["preemptions"]
    assert all(v == 1 for v in tr.first_token_counts().values())
    for rid in out["rids"]:
        rec = b.request_log[rid]
        assert rec["outcome"] == "completed"
        assert "ttft_work" in rec
    assert tr.conservation_ok({"isl": b})["all"]
    assert_same_trace(out, refr)


def test_request_log_migration_carry(cfg, params, ref):
    """Freeze mid-decode on island a, thaw on island b, in both packages:
    the destination record carries the migration and the recorded TTFT,
    ``first_token`` fires only on a, the journal shows freeze ->
    thaw_queue -> one finish, and the two journals are equal."""
    jcfg, jparams, _steps = ref
    out = {}
    for name, make, tracer in (
            ("port", lambda: PagedContinuousBatcher(
                cfg, params=params, num_slots=2, max_len=96, page_size=16,
                device=CPU), Tracer),
            ("ref", lambda: JBatcher(jcfg, params=jparams, num_slots=2,
                                     max_len=96, page_size=16), JTracer)):
        tr = tracer()
        a, b = make(), make()
        a.attach_tracer(tr, island="a")
        b.attach_tracer(tr, island="b")
        rid = a.submit(PREFIX + "migrating request", max_new_tokens=6,
                       trust_tier=2)
        for _ in range(4):
            a.tick()
        assert "ttft_work" in a.request_log[rid]
        t = a.freeze_request(rid)
        assert t is not None and t.phase == "decode"
        brid = b.submit_ticket(t)
        b.run_until_done()
        rec = b.request_log[brid]
        assert rec["migrations"] == 1 and rec["outcome"] == "completed"
        assert len(tr.by_kind("freeze")) == 1
        assert len(tr.by_kind("thaw_queue")) == 1
        assert len(tr.by_kind("finish")) == 1
        assert list(tr.first_token_counts()) == [("a", rid)]
        assert tr.conservation_ok({"a": a, "b": b})["all"]
        out[name] = (journal(tr), a.request_log, b.request_log)
    assert out["port"] == out["ref"]


# ------------------------------------------------------- profiler

def test_profiler_report(ab):
    _off, on, refr = ab
    rep = on["b"].profiler.report()
    assert rep["ticks"] == on["b"].stats["ticks"]
    assert rep["dispatches"] == on["b"].stats["device_dispatches"]
    for p in ("host_plan", "bucket", "dispatch_submit", "device_sync"):
        assert f"{p}_ms" in rep and f"{p}_frac" in rep
    assert rep["unique_shapes"] >= 1
    assert rep["shape_dispatches"] == len(on["b"].dispatch_shapes)
    jrep = refr["b"].profiler.report()
    assert {k: rep[k] for k in PROFILE_KEYS} == \
        {k: jrep[k] for k in PROFILE_KEYS}
    assert on["b"].profiler.shape_counts == refr["b"].profiler.shape_counts


def test_profiler_waits_only_for_a_card():
    """``tick_end`` synchronizes the device that holds the target's
    tensors; a target on the CPU (or none) charges no wait."""
    prof = DispatchProfiler()
    for target in (None, [{"k": torch.zeros(2)}], (torch.zeros(1), None)):
        prof.tick_begin()
        prof.tick_end(target)
    assert prof.totals["device_sync"] == 0
    assert prof.report()["ticks"] == 3
    assert _first_tensor([{"k": [torch.ones(1)]}]).item() == 1.0
    assert _first_tensor([{}, ()]) is None


# -------------------------------------------------------- exporter

def test_chrome_trace_export(ab, tmp_path):
    _off, on, refr = ab
    path = tmp_path / "trace.json"
    n = write_chrome_trace(on["tr"], str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    assert n == len(evs) > 0
    assert all(set(e) >= {"ph", "pid", "tid", "ts"} or e["ph"] == "M"
               for e in evs)
    depth = {}
    for e in evs:
        if e["ph"] in "BE":
            key = (e["pid"], e["tid"])
            depth[key] = depth.get(key, 0) + (1 if e["ph"] == "B" else -1)
    assert all(v == 0 for v in depth.values()), depth
    assert sum(e["ph"] == "s" for e in evs) == \
        sum(e["ph"] == "f" for e in evs)
    # the reference's export of its own journal: the same events, but for
    # the wall-clock timestamps
    jpath = tmp_path / "ref.json"
    jwrite(refr["tr"], str(jpath))
    jevs = json.loads(jpath.read_text())["traceEvents"]

    def untimed(es):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in es]

    assert untimed(evs) == untimed(jevs)


# ------------------------------------------------ tenant boundary

def test_tenant_summary_hardened(ab):
    """The only tenant-visible projection, hardened as lighthouse
    telemetry is: never under-reported, deterministic, and the
    reference's value for the same journal."""
    _off, on, refr = ab
    tr = on["tr"]
    pol = TelemetryPolicy()
    view = tr.tenant_summary(pol, viewer_tier=2)
    true_finishes = sum(
        1 for e in tr.by_kind("finish")
        if isinstance(e.attrs.get("tier"), int) and e.attrs["tier"] >= 2)
    assert view["viewer_tier"] == 2
    assert view["requests_completed"] >= true_finishes
    assert view == tr.tenant_summary(pol, viewer_tier=2)
    for tier in (1, 2, 3):
        assert tr.tenant_summary(pol, viewer_tier=tier) == \
            refr["tr"].tenant_summary(JTelemetryPolicy(), viewer_tier=tier)


# ------------------------------------------------ the serve launcher

def test_serve_launcher_writes_a_trace(tmp_path, capsys):
    """``--trace`` implies ``--batched`` (as the reference's does) and
    writes a Chrome-trace journal in which every submitted request has
    exactly one orchestrator terminal."""
    from repro_torch.launch import serve
    from repro_torch.serving.engine import TickOrchestrator
    path = tmp_path / "serve_trace.json"
    eng = serve.main(["--device", "cpu", "--requests", "12", "--trace",
                      str(path)])
    assert isinstance(eng, TickOrchestrator)
    assert "implies --batched" in capsys.readouterr().out
    rids = list(range(eng._next_rid))
    assert len(rids) == 12 and eng.tracer.terminals_exactly_once(rids)
    doc = json.loads(path.read_text())
    terms = [e for e in doc["traceEvents"] if e.get("pid") == 0
             and e.get("name") in ("complete", "reject", "expire")]
    assert len(terms) == 12
    assert eng.tracer.conservation_ok(eng.batchers)["all"]
