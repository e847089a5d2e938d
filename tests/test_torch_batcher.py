"""The port's fused chunked paged batcher against the reference's, on
the workloads of tests/test_fused_tick.py and tests/test_chunked_prefill.py
with bridged weights.

Every host integer is exactly equal: work clock, scheduling and sharing
counters, launch counts, dispatch geometry, per-request lifecycle records
and pool telemetry. Token streams are compared path for path (fused
chunked against fused chunked) under the margin rule of
``_torch_parity``: bf16 KV pages on a random-weight model make greedy
argmax fragile at near-ties (ROADMAP R1).
"""
import dataclasses

import jax
import pytest

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from _torch_parity import (assert_streams_match, capture_port,
                           capture_reference, reference_steps)
from repro.configs.base import get_config as jget_config
from repro.models.model import get_model as jget_model
from repro.serving.batcher import PagedContinuousBatcher as JBatcher
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models.model import get_model
from repro_torch.serving.batcher import PagedContinuousBatcher as TBatcher
from repro_torch.serving.batcher import make_batcher

# one torch thread, and the reference's step functions shared by
# every batcher of a config (``_torch_parity.lean_cpu``)
pytestmark = pytest.mark.usefixtures("lean_cpu")

PREFIX = "shared clinical preamble for the cohort under review. "
MIXED = [
    (PREFIX + "alpha " * 12, 8, 0),
    (PREFIX + "beta " * 16, 6, 0),
    ("an unrelated billing request with no shared head", 8, 1),
    (PREFIX + "gamma " * 4, 10, 0),
    ("tiny", 5, None),
    (PREFIX + "delta " * 20, 7, 0),
]
SHARED = [(PREFIX + f"variant {i} " * 3, 6, 2) for i in range(6)]
MANY = [(f"request number {i} " + "filler " * (4 + 3 * i), 5, i % 3)
        for i in range(8)]
CHUNKED = [(p, 4, 2) for p in ["short",
                               "a somewhat longer request that spans pages",
                               "mid-size prompt here", "x" * 40]]
COW = [("identical prompt shared by two live sequences", 5, 1)] * 2
TIERS = [("the same sensitive prompt at every trust tier", 4, t)
         for t in (1, 2, 3, None)]

WORKLOADS = {
    "mixed": (MIXED, dict(num_slots=3, max_len=96)),
    "shared_prefix": (SHARED, dict(num_slots=3, max_len=96)),
    "dispatch_bound": (MANY, dict(num_slots=4, max_len=96,
                                  prefill_token_budget=96)),
    "chunked_budget": (CHUNKED, dict(num_slots=2, max_len=64,
                                     prefill_token_budget=16)),
    "prefix_cow": (COW, dict(num_slots=2, max_len=64)),
    "distinct_tiers": (TIERS, dict(num_slots=4, max_len=64)),
}
EXACT_STATS = ("ticks", "admissions", "prefill_dispatches",
               "prefix_tokens_skipped", "device_dispatches",
               "tick_dispatches_max", "decode_steps", "decode_tokens",
               "share_hits", "cow_copies", "prefill_chunk_tokens",
               "rejected_too_large", "queued_peak")


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("smollm-135m").reduced()
    tcfg = tget_config("smollm-135m").reduced()
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), "float32")
    tparams = bridge.from_reference(tcfg, jax.device_get(jparams))
    return jcfg, tcfg, jparams, tparams, reference_steps(jmodel)


def _run(weights, workload, **kw):
    jcfg, tcfg, jparams, tparams, steps = weights
    kw.setdefault("page_size", 16)
    jb = JBatcher(jcfg, params=jparams, fused=True, **kw)
    tb = TBatcher(tcfg, params=tparams, device="cpu", **kw)
    jtok, jmargin = capture_reference(jb, steps)
    ttok = capture_port(tb)
    for p, mn, tier in workload:
        assert jb.submit(p, max_new_tokens=mn, trust_tier=tier) == \
            tb.submit(p, max_new_tokens=mn, trust_tier=tier)
    jdone, tdone = jb.run_until_done(), tb.run_until_done()
    assert sorted(jdone) == sorted(tdone)
    return jb, tb, (jtok, jmargin, ttok)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_port_batcher_matches_reference(weights, name):
    workload, kw = WORKLOADS[name]
    jb, tb, (jtok, jmargin, ttok) = _run(weights, workload, **kw)
    assert tb.work_clock == jb.work_clock
    for key in EXACT_STATS:
        assert tb.stats[key] == jb.stats[key], key
    assert tb.dispatch_shapes == jb.dispatch_shapes
    assert tb.request_log == jb.request_log
    assert tb.tier_work == jb.tier_work
    assert tb.pool.telemetry() == jb.pool.telemetry()
    assert tb.pool.tier_telemetry() == jb.pool.tier_telemetry()
    assert tb.pool.in_use() == 0 and tb.reserved == 0 and tb.pool.audit()
    assert tb.stats["tick_dispatches_max"] <= 2
    diverged = assert_streams_match(jtok, jmargin, ttok)
    assert diverged <= len(jtok) // 2, "most streams must match in full"


def test_backlog_and_telemetry_match_mid_run(weights):
    """The orchestrator-facing signals agree tick by tick, not only at the
    end: prefill backlog (total and per tier) and tier telemetry."""
    jcfg, tcfg, jparams, tparams, steps = weights
    jb = JBatcher(jcfg, params=jparams, num_slots=2, max_len=96,
                  page_size=16, prefill_token_budget=16)
    jb._fused_prefill, jb._fused_decode = steps["prefill"], steps["decode"]
    tb = TBatcher(tcfg, params=tparams, num_slots=2, max_len=96,
                  page_size=16, prefill_token_budget=16, device="cpu")
    for p, mn, tier in MIXED:
        jb.submit(p, max_new_tokens=mn, trust_tier=tier)
        tb.submit(p, max_new_tokens=mn, trust_tier=tier)
    while jb.busy():
        assert tb.busy()
        assert tb.prefill_backlog_tokens() == jb.prefill_backlog_tokens()
        assert tb.tier_telemetry() == jb.tier_telemetry()
        assert tb.utilization() == jb.utilization()
        jb.tick()
        tb.tick()
        assert tb.blocked_last_tick == jb.blocked_last_tick
    assert not tb.busy()


def test_unported_paths_refuse_clearly(weights):
    """Since P12b the port refuses no configuration of the catalog: MoE
    (kimi) and MLA (deepseek) build and ``make_batcher(cache="auto")``
    serves them, on the paged pool and the stacked batcher, as the
    reference picks. Stochastic sampling is ported: both batchers serve
    ``temperature=0.9``; so is the prefix-LM mask, with or without its
    frontend. The name is the test's since PR 12."""
    _, tcfg, _, tparams, _ = weights
    for b in (TBatcher(tcfg, params=tparams, temperature=0.9, device="cpu"),
              make_batcher(tcfg, cache="stacked", params=tparams,
                           temperature=0.9, device="cpu")):
        rid = b.submit("a sampled request", max_new_tokens=4, trust_tier=2)
        text = b.run_until_done()[rid]
        assert text is not None and b.stats["decode_tokens"] >= 3
    moe = tget_config("kimi-k2-1t-a32b").reduced()
    get_model(moe)
    assert isinstance(make_batcher(moe, cache="auto", device="cpu"),
                      TBatcher)
    mla = tget_config("deepseek-v2-lite-16b").reduced()
    b = make_batcher(mla, cache="auto", device="cpu")
    assert not isinstance(b, TBatcher)
    rid = b.submit("a latent-cache request", max_new_tokens=3, trust_tier=2)
    assert b.run_until_done()[rid] is not None
    # a prefix-LM config without its frontend is served: the reference
    # attends the prefix both ways whatever the frontend, and so does the
    # port in mode="full"
    plm = dataclasses.replace(tget_config("paligemma-3b").reduced(),
                              frontend=None)
    assert plm.prefix_lm and plm.num_prefix_tokens
    get_model(plm)
    b = make_batcher(plm, cache="auto", device="cpu")
    rid = b.submit("a prefix-LM request", max_new_tokens=3, trust_tier=2)
    assert b.run_until_done()[rid] is not None


def test_prefix_lm_is_named_with_its_frontend():
    """The reference applies the prefix-LM mask whatever the frontend; the
    port admits paligemma with its vision frontend as it admits it
    without, and musicgen with its audio frontend."""
    for arch in ("paligemma-3b", "musicgen-large"):
        get_model(tget_config(arch).reduced())
        get_model(tget_config(arch))
