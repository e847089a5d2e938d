"""The port's orchestrator against the reference's.

* ``route_batch_tick`` on tensors gives the decisions of the reference's
  JAX router and of scalar ``waves.route``, on tests/test_orchestrator.py's
  workloads and policies, and writes the same TIDE state back.
* The quickstart mesh served through both orchestrators (bridged
  weights) gives every request the same island and ``sanitized`` flag,
  equal ``tick_stats`` for the keys the port keeps, and the same tokens
  under the margin rule of ``_torch_parity``.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro_torch.core.waves as twaves
from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from _torch_parity import (assert_streams_match, capture_port,
                           capture_reference, reference_steps)
from repro.configs.base import get_config as jget_config
from repro.core import islands as jisl
from repro.core.lighthouse import Lighthouse as JLighthouse
from repro.core.mist import MIST as JMIST
from repro.core.tide import TIDE as JTIDE
from repro.core.waves import WAVES as JWAVES
from repro.core.waves import Policy as JPolicy
from repro.core.waves import Request
from repro.core.workload import healthcare_workload, legal_workload
from repro.serving.engine import TickOrchestrator as JOrch
from repro.serving.engine import build_island_batchers as jbuild
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import islands as tisl
from repro_torch.core.lighthouse import Lighthouse as TLighthouse
from repro_torch.core.mist import MIST as TMIST
from repro_torch.core.tide import TIDE as TTIDE
from repro_torch.serving.engine import TickOrchestrator as TOrch
from repro_torch.serving.engine import build_island_batchers as tbuild

# one torch thread, and the reference's step functions shared by
# every batcher of a config (``_torch_parity.lean_cpu``)
pytestmark = pytest.mark.usefixtures("lean_cpu")

ROUTER_MESH = [
    ("personal_island", "laptop", dict(latency_ms=120, capacity_units=3.0)),
    ("personal_island", "phone", dict(latency_ms=250, capacity_units=0.5)),
    ("edge_island", "home-nas", dict(privacy=0.9, latency_ms=300)),
    ("edge_island", "clinic-edge", dict(privacy=0.8, latency_ms=450,
                                        datasets=("medlit",),
                                        capacity_units=6.0)),
    ("cloud_island", "gpt4-api", dict(privacy=0.4, cost=0.02,
                                      latency_ms=900, models=("gpt-4",))),
    ("cloud_island", "claude-api", dict(privacy=0.5, cost=0.015,
                                        latency_ms=800)),
]
QUICKSTART_MESH = [
    ("personal_island", "laptop", dict(latency_ms=120, capacity_units=3.0)),
    ("personal_island", "phone", dict(latency_ms=250, capacity_units=0.5)),
    ("edge_island", "home-nas", dict(privacy=0.9, latency_ms=300)),
    ("cloud_island", "gpt4-api", dict(privacy=0.4, cost=0.02,
                                      latency_ms=900)),
]
QUERIES = [
    ("Analyze treatment options for 45-year-old diabetic patient "
     "John Doe with elevated HbA1c", "primary"),
    ("What are common diabetes complications", "burstable"),
    ("password = hunter2, please rotate the production key", "secondary"),
    ("best hiking trails near mountains", "burstable"),
]


def _stack(pkg, mesh, policy_kw=None, crashed=False):
    isl, mist, tide, lh, waves = pkg
    reg = isl.IslandRegistry()
    for kind, iid, kw in mesh:
        island = getattr(isl, kind)(iid, **kw)
        reg.register(island, reg.attestation_token(iid))
    t = tide(reg)
    t.crashed = crashed
    lighthouse = lh(reg)
    for i in reg.all():
        lighthouse.heartbeat(i.island_id)
    return reg, waves.WAVES(mist(), t, lighthouse,
                            waves.Policy(**(policy_kw or {})))


JAX_PKG = (jisl, JMIST, JTIDE, JLighthouse,
           type("W", (), {"WAVES": JWAVES, "Policy": JPolicy}))
PORT_PKG = (tisl, TMIST, TTIDE, TLighthouse, twaves)


def _key(ds):
    return [(d.accepted, d.island.island_id if d.accepted else None,
             str(d.reason), d.n_candidates) for d in ds]


def _port(reqs):
    return [twaves.Request(**dataclasses.asdict(r)) for r in reqs]


def _healthcare_legal():
    return ([r for r, _ in healthcare_workload(32, seed=3)]
            + [r for r, _ in legal_workload(16, seed=5)])


SPECIAL = [
    Request(query="summarize quarterly numbers", deadline_ms=200.0),
    Request(query="check medlit for trial outcomes", dataset="medlit"),
    Request(query="draft a note", model="gpt-4", sensitivity_override=0.1),
    Request(query="personal journal entry", priority="primary"),
    Request(query="weather tomorrow", priority="burstable"),
    Request(query="weather tomorrow again", priority="burstable"),
    Request(query="patient John Doe labs", priority="secondary"),
] * 3


@pytest.mark.parametrize("case", [
    ("scalarized", {}, False, "mixed"),
    ("constraint", {"mode": "constraint"}, False, "mixed"),
    ("queue_local", {"on_infeasible": "queue_local", "min_trust": 0.9},
     False, "mixed"),
    ("budget", {"budget_per_request": 0.016}, False, "mixed"),
    ("special", {}, False, "special"),
    ("crashed_tide", {}, True, "mixed"),
], ids=lambda c: c[0])
def test_tick_router_matches_reference_and_scalar(case):
    _, policy_kw, crashed, wl_name = case
    wl = SPECIAL if wl_name == "special" else _healthcare_legal()
    _, ws = _stack(JAX_PKG, ROUTER_MESH, policy_kw, crashed)
    scalar = _key([ws.route(r) for r in wl])
    jreg, wj = _stack(JAX_PKG, ROUTER_MESH, policy_kw, crashed)
    jd = JOrch(wj, jreg).route_pool(wl)
    treg, wt = _stack(PORT_PKG, ROUTER_MESH, policy_kw, crashed)
    td = TOrch(wt, treg, device="cpu").route_pool(_port(wl))
    # the scalar path counts candidates itself; compare routing decisions
    assert [k[:3] for k in _key(td)] == [k[:3] for k in scalar]
    assert _key(td) == _key(jd)
    for a, b in zip(td, jd):
        assert (a.score is None) == (b.score is None)
        if a.score is not None:
            assert a.score == pytest.approx(b.score, abs=1e-6)
        assert a.sanitize == b.sanitize
    # the router's final TIDE state is written back identically
    for isl in jreg.all():
        sa, sb = wj.tide._st(isl.island_id), wt.tide._st(isl.island_id)
        assert sa.local_ok == sb.local_ok
        for f in ("cpu", "gpu", "mem", "inflight"):
            assert getattr(sb, f) == pytest.approx(getattr(sa, f), abs=1e-6)


def test_no_intra_tick_oversubscription_like_reference():
    mesh = [("personal_island", "laptop",
             dict(latency_ms=100, capacity_units=1.0)),
            ("edge_island", "edge-a",
             dict(privacy=0.9, latency_ms=300, capacity_units=2.0)),
            ("cloud_island", "cloud",
             dict(privacy=0.9, cost=0.02, latency_ms=900))]
    reqs = [Request(query=f"low sensitivity question {i}",
                    sensitivity_override=0.1) for i in range(12)]
    jreg, wj = _stack(JAX_PKG, mesh)
    treg, wt = _stack(PORT_PKG, mesh)
    jd = JOrch(wj, jreg).route_pool(reqs)
    td = TOrch(wt, treg, device="cpu").route_pool(_port(reqs))
    assert _key(td) == _key(jd)
    assert sum(d.island.island_id == "laptop" for d in td) == 1


@pytest.fixture(scope="module")
def quickstart_runs():
    jcfg = jget_config("smollm-135m").reduced()
    tcfg = tget_config("smollm-135m").reduced()
    jreg, wj = _stack(JAX_PKG, QUICKSTART_MESH)
    treg, wt = _stack(PORT_PKG, QUICKSTART_MESH)
    jb = jbuild(jcfg, jreg, cache="paged", max_len=96)
    params = next(iter(jb.values())).params
    tb = tbuild(tcfg, treg, params=bridge.from_reference(
        tcfg, jax.device_get(params)), max_len=96, device="cpu")
    assert {k: b.num_slots for k, b in tb.items()} == \
        {k: b.num_slots for k, b in jb.items()} == \
        {"laptop": 6, "phone": 1, "home-nas": 8}
    steps = reference_steps(next(iter(jb.values())).model)
    caps = {iid: (capture_reference(b, steps), capture_port(tb[iid]))
            for iid, b in jb.items()}
    jo, to = JOrch(wj, jreg, jb), TOrch(wt, treg, tb, device="cpu")
    reqs = [Request(query=q, priority=p) for q, p in QUERIES]
    reqs += [r for r, _ in healthcare_workload(6, seed=11)]
    jr = [jo.submit(r, max_new_tokens=8) for r in reqs]
    tr = [to.submit(r, max_new_tokens=8) for r in _port(reqs)]
    assert jr == tr
    jo.run_until_done()
    to.run_until_done()
    return jo, to, jr, caps


def test_quickstart_same_islands_and_sanitization(quickstart_runs):
    jo, to, rids, _ = quickstart_runs
    assert set(to.results) == set(jo.results) == set(rids)
    for rid in rids:
        a, b = jo.results[rid], to.results[rid]
        assert (a is None) == (b is None)
        if a is not None:
            assert (b.island_id, b.sanitized) == (a.island_id, a.sanitized)
            assert b.sensitivity == a.sensitivity
            assert b.latency_ms == pytest.approx(a.latency_ms)
    assert len(to.log) == len(jo.log) and len(to.rejected) == \
        len(jo.rejected)
    for key in ("ticks", "route_calls", "routed", "decode_ticks",
                "admissions", "prefill_dispatches", "device_dispatches",
                "tick_dispatches_max", "pool_peak"):
        assert to.tick_stats[key] == jo.tick_stats[key], key
    js, ts = jo.stats(), to.stats()
    for key in ("n", "rejected", "cost_total", "privacy_violations",
                "sanitized", "by_island", "utilization", "kv_pools",
                "prefill_backlog"):
        assert ts[key] == js[key], key


def test_quickstart_tokens_under_margin_rule(quickstart_runs):
    jo, to, _, caps = quickstart_runs
    served = 0
    for iid, ((jtok, jmargin), ttok) in caps.items():
        assert_streams_match(jtok, jmargin, ttok)
        served += len(jtok)
    assert served >= 4
    # texts match wherever the streams matched in full
    same = sum(jo.results[r].text == to.results[r].text
               for r in jo.results if jo.results[r] is not None)
    assert same >= len(jo.log) // 2
    assert np.all([r.island_id for r in to.log])
