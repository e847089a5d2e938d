"""mamba2 served by the port against the reference, with bridged weights,
at ``mamba2-370m`` ``.reduced()``.

* The stacked ``ContinuousBatcher`` (the only cache manager an SSM config
  has): admission prefills one request (K5 on every layer), writes its
  ``{"conv", "h"}`` row into the slot, and ONE decode dispatch serves
  every slot. Every host integer is exactly equal (stats, work clock,
  per-request records), and the slot rows agree after the run.
* ``build_island_batchers(cache="auto")`` resolves to the stacked manager
  on both sides, and ``TickOrchestrator`` over it on the quickstart mesh
  routes and serves as the reference does.
* ``LocalModelServer.generate`` (one prompt, and two unequal prompts that
  both sides pad after the shorter one, ROADMAP R5), and the serve
  launcher's ``--arch mamba2-370m`` on both of its paths.
* ``make_batcher(cache="paged")`` refuses mamba2 as the reference does.

Token streams are compared under the margin rule of ``_torch_parity``
(ROADMAP R1): a bf16 conv tail on a random-weight model makes greedy
argmax fragile at near-ties. The slot rows after a run hold to one bf16
ulp plus 1e-3, as tests/test_torch_ssm_model.py holds decoded caches.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.serving.engine as jengine
import repro_torch.core.waves as twaves
import repro_torch.launch.serve as tserve
import repro_torch.serving.engine as tengine
from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from _torch_parity import (assert_streams_match, capture_port,
                           capture_reference_host, top2_margin)
from repro.configs.base import get_config as jget_config
from repro.core.waves import Request
from repro.core.workload import healthcare_workload
from repro.models.model import get_model as jget_model
from repro.serving.batcher import ContinuousBatcher as JBatcher
from repro.serving.batcher import make_batcher as jmake_batcher
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.serving.batcher import ContinuousBatcher as TBatcher
from repro_torch.serving.batcher import PagedContinuousBatcher
from repro_torch.serving.batcher import make_batcher as tmake_batcher
from test_torch_engine import (JAX_PKG, PORT_PKG, QUERIES, QUICKSTART_MESH,
                               _stack)

# one torch thread, and the reference's step functions shared by
# every batcher of a config (``_torch_parity.lean_cpu``)
pytestmark = pytest.mark.usefixtures("lean_cpu")

PREFIX = "shared clinical preamble for the cohort under review. "
WORKLOADS = {
    "mixed": ([(PREFIX + "alpha " * 12, 8, 0), ("tiny", 5, None),
               ("an unrelated billing request with no shared head", 8, 1),
               (PREFIX + "gamma " * 4, 10, 0), ("ab", 4, 2),
               (PREFIX + "delta " * 20, 7, 0)],
              dict(num_slots=3, max_len=192)),
    "queue_pressure": ([(f"request number {i} " + "filler " * (4 + 3 * i),
                         5, i % 3) for i in range(8)],
                       dict(num_slots=2, max_len=128)),
}
EXACT_STATS = ("ticks", "admissions", "prefills", "prefill_dispatches",
               "device_dispatches", "tick_dispatches_max", "decode_steps",
               "decode_tokens", "queued_peak")
ROW_TOL = dict(rtol=2 ** -7, atol=1e-3)


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("mamba2-370m").reduced()
    tcfg = tget_config("mamba2-370m").reduced()
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0), "float32")
    tparams = bridge.from_reference(tcfg, jax.device_get(jparams))
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_stacked_batcher_matches_reference(weights, name):
    jcfg, tcfg, jparams, tparams = weights
    workload, kw = WORKLOADS[name]
    jb = JBatcher(jcfg, params=jparams, **kw)
    tb = TBatcher(tcfg, params=tparams, device="cpu", **kw)
    jtok, jmargin = capture_reference_host(jb)
    ttok = capture_port(tb)
    for p, mn, tier in workload:
        assert jb.submit(p, max_new_tokens=mn, trust_tier=tier) == \
            tb.submit(p, max_new_tokens=mn, trust_tier=tier)
    jdone, tdone = jb.run_until_done(), tb.run_until_done()
    assert sorted(jdone) == sorted(tdone) == list(range(len(workload)))
    assert tb.work_clock == jb.work_clock
    for key in EXACT_STATS:
        assert tb.stats[key] == jb.stats[key], key
    assert tb.request_log == jb.request_log
    assert tb.tier_work == jb.tier_work
    assert not tb.busy() and tb.utilization() == 0
    diverged = assert_streams_match(jtok, jmargin, ttok)
    assert diverged <= len(jtok) // 2, "most streams must match in full"
    if diverged:
        return                         # a stream parted: its row differs
    # each slot row holds its last occupant's state, decoded on by the
    # dummy steps of the idle ticks after it finished, as the reference's
    ref = jax.device_get(jb._cache)
    for si in range(kw["num_slots"]):
        want = bridge.dense_cache_from_reference(
            tcfg, jax.tree.map(lambda x: x[si], ref))
        for got_l, want_l in zip(tb._cache, want):
            for n in ("conv", "h"):
                assert got_l[n].dtype == want_l[n].dtype
                np.testing.assert_allclose(
                    got_l[n][si].float().numpy(),
                    want_l[n][0].float().numpy(), **ROW_TOL)


def test_island_batchers_resolve_to_stacked_and_serve(weights):
    """``cache="auto"`` gives every SHORE island a stacked batcher on both
    sides; the orchestrator routes, batches and streams as the
    reference."""
    jcfg, tcfg, jparams, tparams = weights
    jreg, wj = _stack(JAX_PKG, QUICKSTART_MESH)
    treg, wt = _stack(PORT_PKG, QUICKSTART_MESH)
    jb = jengine.build_island_batchers(jcfg, jreg, params=jparams,
                                       max_len=128)
    tb = tengine.build_island_batchers(tcfg, treg, params=tparams,
                                       max_len=128, device="cpu")
    assert {k: b.num_slots for k, b in tb.items()} == \
        {k: b.num_slots for k, b in jb.items()}
    assert all(isinstance(b, TBatcher) for b in tb.values())
    assert all(isinstance(b, JBatcher) for b in jb.values())
    caps = {iid: (capture_reference_host(b), capture_port(tb[iid]))
            for iid, b in jb.items()}
    jo = jengine.TickOrchestrator(wj, jreg, jb)
    to = tengine.TickOrchestrator(wt, treg, tb, device="cpu")
    reqs = [Request(query=q, priority=p) for q, p in QUERIES]
    reqs += [r for r, _ in healthcare_workload(6, seed=11)]
    for r in reqs:
        assert jo.submit(r, max_new_tokens=8) == to.submit(
            twaves.Request(**dataclasses.asdict(r)), max_new_tokens=8)
    jo.run_until_done()
    to.run_until_done()
    assert sorted(to.results) == sorted(jo.results)
    for rid, a in jo.results.items():
        b = to.results[rid]
        assert (a is None) == (b is None)
        if a is not None:
            assert (b.island_id, b.sanitized) == (a.island_id, a.sanitized)
            assert b.latency_ms == pytest.approx(a.latency_ms)
    for key in ("ticks", "route_calls", "routed", "decode_ticks",
                "admissions", "prefill_dispatches", "device_dispatches",
                "tick_dispatches_max", "pool_peak"):
        assert to.tick_stats[key] == jo.tick_stats[key], key
    served = 0
    for iid, ((jtok, jmargin), ttok) in caps.items():
        assert_streams_match(jtok, jmargin, ttok)
        served += len(jtok)
    assert served >= 4


def _record_reference(js):
    """The top-2 margin behind every token of a reference server's latest
    ``generate`` call, keyed by batch row and step."""
    margins = {}
    prefill, decode = js._prefill, js._decode
    step = [0]

    def pre(params, cache, inputs):
        out = prefill(params, cache, inputs)
        step[0] = 0
        for r, row in enumerate(np.asarray(out[0])):
            margins.setdefault(r, {})[0] = top2_margin(row)
        return out

    def dec(params, cache, tok, pos):
        out = decode(params, cache, tok, pos)
        step[0] += 1
        for r, row in enumerate(np.asarray(out[0])):
            margins[r][step[0]] = top2_margin(row)
        return out

    js._prefill, js._decode = pre, dec
    return margins


@pytest.mark.parametrize("prompts", [["What are common diabetes "
                                      "complications"],
                                     ["ab", "a considerably longer second "
                                      "prompt that pads the first one"]],
                         ids=["one", "two_unequal"])
def test_local_server_matches_reference(weights, prompts):
    jcfg, tcfg, jparams, tparams = weights
    js = jengine.LocalModelServer(jcfg, params=jparams, max_len=128)
    ts = tengine.LocalModelServer(tcfg, params=tparams, max_len=128,
                                  device="cpu")
    margins = _record_reference(js)
    _, jtoks = js.generate(prompts, max_new_tokens=6)
    _, ttoks = ts.generate(prompts, max_new_tokens=6)
    assert ttoks.shape == jtoks.shape == (len(prompts), 6)
    assert_streams_match(
        {r: [int(t) for t in jtoks[r]] for r in range(len(prompts))},
        margins, {r: [int(t) for t in ttoks[r]] for r in range(len(prompts))})


def test_paged_cache_refuses_mamba2_as_the_reference(weights):
    jcfg, tcfg, jparams, tparams = weights
    with pytest.raises(ValueError, match="cache='stacked'") as jerr:
        jmake_batcher(jcfg, cache="paged", params=jparams, num_slots=2,
                      max_len=64)
    with pytest.raises(ValueError, match="cache='stacked'") as terr:
        tmake_batcher(tcfg, cache="paged", params=tparams, num_slots=2,
                      max_len=64, device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="attention-only"):
        PagedContinuousBatcher(tcfg, params=tparams, device="cpu")
    b = tmake_batcher(tcfg, params=tparams, num_slots=2, max_len=64,
                      device="cpu")
    assert isinstance(b, TBatcher)
    assert [sorted(layer) for layer in b._cache] == \
        [["conv", "h"]] * tcfg.num_layers


@pytest.mark.parametrize("batched", [False, True])
def test_serve_launcher_runs_mamba2(batched):
    argv = ["--arch", "mamba2-370m", "--device", "cpu", "--requests", "6",
            "--max-new-tokens", "4"] + (["--batched"] if batched else [])
    eng = tserve.main(argv)
    stats = eng.stats()
    assert stats["n"] == 6
    assert sum(stats["by_island"].values()) + stats["rejected"] == 6
