"""The port's per-request path and its stacked orchestrator path against
the reference's, with bridged weights.

* ``LocalModelServer.generate`` (full-prompt prefill into a dense cache,
  greedy decode at one shared position): one prompt, and a batch of two
  unequal prompts, which both sides pad after the shorter one (ROADMAP
  R5, reproduced as is).
* ``InferenceEngine`` on the serve launcher's mesh over a healthcare
  workload: the same island, sanitization and virtual latency for every
  request. ``InferenceEngine`` advances virtual time by the measured
  execution time, so each engine module's ``time`` is replaced by one
  deterministic clock.
* ``TickOrchestrator`` over ``build_island_batchers(cache="stacked")`` on
  the quickstart mesh: the same islands and tick statistics.

Token streams are compared under the margin rule of ``_torch_parity``
(ROADMAP R1).
"""
import dataclasses
import types

import jax
import numpy as np
import pytest

import repro.serving.engine as jengine
import repro_torch.core.waves as twaves
import repro_torch.launch.serve as tserve
import repro_torch.serving.engine as tengine
from _torch_parity import (assert_streams_match, capture_port,
                           capture_reference_host, top2_margin)
from repro.configs.base import get_config as jget_config
from repro.core.waves import Request
from repro.core.workload import healthcare_workload
from repro.launch import serve as jserve
from repro.models.model import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from test_torch_engine import (JAX_PKG, PORT_PKG, QUERIES, QUICKSTART_MESH,
                               _stack)

LONG = ("a considerably longer second prompt that pads the first one "
        "in the batch")


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("smollm-135m").reduced()
    tcfg = tget_config("smollm-135m").reduced()
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0), "float32")
    tparams = bridge.from_reference(tcfg, jax.device_get(jparams))
    return jcfg, tcfg, jparams, tparams


def _servers(weights, max_len=128):
    jcfg, tcfg, jparams, tparams = weights
    js = jengine.LocalModelServer(jcfg, params=jparams, max_len=max_len)
    ts = tengine.LocalModelServer(tcfg, params=tparams, max_len=max_len,
                                  device="cpu")
    return js, ts


def _record_reference(js):
    """Wrap a reference server's steps so that they record the top-2
    margin behind every token of its latest ``generate`` call, keyed by
    batch row and step."""
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
                                     ["short", LONG]],
                         ids=["one", "two_unequal"])
def test_local_server_matches_reference(weights, prompts):
    js, ts = _servers(weights)
    margins = _record_reference(js)
    jtexts, jtoks = js.generate(prompts, max_new_tokens=6)
    ttexts, ttoks = ts.generate(prompts, max_new_tokens=6)
    assert ttoks.shape == jtoks.shape == (len(prompts), 6)
    assert_streams_match(
        {r: [int(t) for t in jtoks[r]] for r in range(len(prompts))},
        margins, {r: [int(t) for t in ttoks[r]] for r in range(len(prompts))})
    assert len(ttexts) == len(prompts)
    if np.array_equal(ttoks, jtoks):
        assert ttexts == list(jtexts)


def _clock():
    """A stand-in for the ``time`` module: perf_counter steps 50 ms a
    call, so every local request measures the same execution time."""
    t = [0.0]

    def perf_counter():
        t[0] += 0.05
        return t[0]

    return types.SimpleNamespace(perf_counter=perf_counter)


def test_inference_engine_matches_reference(weights, monkeypatch):
    monkeypatch.setattr(jengine, "time", _clock())
    monkeypatch.setattr(tengine, "time", _clock())
    js, ts = _servers(weights)
    js2, ts2 = _servers(weights)
    runs = []
    for serve, eng_mod, servers in (
            (jserve, jengine, {"laptop": js, "home-nas": js2}),
            (tserve, tengine, {"laptop": ts, "home-nas": ts2})):
        reg, waves = serve.build_mesh()
        runs.append((eng_mod.InferenceEngine(waves, reg, servers), servers))
    # every local generate call of the reference, with its margins
    calls = {"ref": [], "port": []}
    for srv in runs[0][1].values():
        margins = _record_reference(srv)
        gen = srv.generate

        def ref_gen(prompts, max_new_tokens=16, gen=gen, margins=margins):
            texts, toks = gen(prompts, max_new_tokens)
            calls["ref"].append(([int(t) for t in toks[0]],
                                 dict(margins[0])))
            return texts, toks

        srv.generate = ref_gen
    for srv in runs[1][1].values():
        gen = srv.generate

        def port_gen(prompts, max_new_tokens=16, gen=gen):
            texts, toks = gen(prompts, max_new_tokens)
            calls["port"].append([int(t) for t in toks[0]])
            return texts, toks

        srv.generate = port_gen
    wl = [r for r, _ in healthcare_workload(12, seed=0)]
    (jeng, _), (teng, _) = runs
    jres = [jeng.submit(r, max_new_tokens=6) for r in wl]
    tres = [teng.submit(twaves.Request(**dataclasses.asdict(r)),
                        max_new_tokens=6) for r in wl]
    for a, b in zip(jres, tres):
        assert (a is None) == (b is None)
        if a is not None:
            assert (b.island_id, b.sanitized) == (a.island_id, a.sanitized)
            assert b.sensitivity == a.sensitivity
            assert b.latency_ms == pytest.approx(a.latency_ms)
    js_, ts_ = jeng.stats(), teng.stats()
    for key in ("n", "rejected", "cost_total", "privacy_violations",
                "sanitized", "by_island"):
        assert ts_[key] == js_[key], key
    assert len(calls["port"]) == len(calls["ref"]) > 0
    assert_streams_match(
        {i: t for i, (t, _m) in enumerate(calls["ref"])},
        {i: m for i, (_t, m) in enumerate(calls["ref"])},
        dict(enumerate(calls["port"])))


def test_stacked_orchestrator_matches_reference(weights):
    jcfg, tcfg, jparams, tparams = weights
    jreg, wj = _stack(JAX_PKG, QUICKSTART_MESH)
    treg, wt = _stack(PORT_PKG, QUICKSTART_MESH)
    jb = jengine.build_island_batchers(jcfg, jreg, cache="stacked",
                                       params=jparams, max_len=96)
    tb = tengine.build_island_batchers(tcfg, treg, cache="stacked",
                                       params=tparams, max_len=96,
                                       device="cpu")
    assert {k: b.num_slots for k, b in tb.items()} == \
        {k: b.num_slots for k, b in jb.items()}
    assert all(not hasattr(b, "pool") for b in tb.values())
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
