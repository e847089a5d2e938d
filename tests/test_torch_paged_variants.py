"""The port's paged batcher in its baseline modes and under pool
exhaustion, against the reference in the same mode, with bridged weights.

* ``prefill="full"`` (one full-prompt dispatch per admission, scattered
  into the pool by ``write_prompt_pages``) and ``fused=False`` (one
  dispatch per chunk run, host-sampled decode) against the reference's
  same modes: every deterministic host integer is equal (stats, work
  clock, dispatch geometry, lifecycle records, pool telemetry) and the
  streams are equal under the margin rule of ``_torch_parity`` (ROADMAP
  R1).
* Inside the port, fused and unfused give identical streams.
* An oversubscribed pool (4 slots, 6 pages) preempts in the port as in
  the reference: the same number of preemptions, the same victims in the
  same order, every request finished, streams under the margin rule.
"""
import jax
import pytest

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from _torch_parity import (assert_streams_match, capture_port,
                           capture_reference, capture_reference_host,
                           reference_steps)
from repro.configs.base import get_config as jget_config
from repro.models.model import get_model as jget_model
from repro.serving.batcher import PagedContinuousBatcher as JBatcher
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.serving.batcher import PagedContinuousBatcher as TBatcher

# one torch thread, and the reference's step functions shared by
# every batcher of a config (``_torch_parity.lean_cpu``)
pytestmark = pytest.mark.usefixtures("lean_cpu")

PREFIX = "shared clinical preamble for the cohort under review. "
WORKLOADS = {
    "mixed": ([(PREFIX + "alpha " * 12, 8, 0), (PREFIX + "beta " * 16, 6, 0),
               ("an unrelated billing request with no shared head", 8, 1),
               (PREFIX + "gamma " * 4, 10, 0), ("tiny", 5, None),
               (PREFIX + "delta " * 20, 7, 0)],
              dict(num_slots=3, max_len=96)),
    "shared_prefix": ([(PREFIX + f"variant {i} " * 3, 6, 2)
                       for i in range(6)], dict(num_slots=3, max_len=96)),
    "chunked_budget": ([(p, 4, 2) for p in [
        "short", "a somewhat longer request that spans pages",
        "mid-size prompt here", "x" * 40]],
        dict(num_slots=2, max_len=64, prefill_token_budget=16)),
    "prefix_cow": ([("identical prompt shared by two live sequences", 5,
                     1)] * 2, dict(num_slots=2, max_len=64)),
}
MODES = {"full": dict(prefill="full"), "unfused": dict(fused=False)}
EXACT_STATS = ("ticks", "admissions", "prefills", "prefill_dispatches",
               "prefix_tokens_skipped", "device_dispatches",
               "tick_dispatches_max", "decode_steps", "decode_tokens",
               "share_hits", "cow_copies", "prefill_chunk_tokens",
               "rejected_too_large", "queued_peak", "stalls", "preemptions")
OVERSUBSCRIBED = ([(f"tiny seed {i}", 40, i % 2) for i in range(4)],
                  dict(num_slots=4, max_len=96, num_pages=6))


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
    jb = JBatcher(jcfg, params=jparams, **kw)
    tb = TBatcher(tcfg, params=tparams, device="cpu", **kw)
    if jb.fused:
        jtok, jmargin = capture_reference(jb, steps)
    else:
        jtok, jmargin = capture_reference_host(jb)
    ttok = capture_port(tb)
    for p, mn, tier in workload:
        assert jb.submit(p, max_new_tokens=mn, trust_tier=tier) == \
            tb.submit(p, max_new_tokens=mn, trust_tier=tier)
    jdone, tdone = jb.run_until_done(), tb.run_until_done()
    assert sorted(jdone) == sorted(tdone) == list(range(len(workload)))
    assert all(t is not None for t in tdone.values())
    return jb, tb, (jtok, jmargin, ttok)


def _assert_same(jb, tb, streams):
    assert tb.work_clock == jb.work_clock
    for key in EXACT_STATS:
        assert tb.stats[key] == jb.stats[key], key
    assert tb.dispatch_shapes == jb.dispatch_shapes
    assert tb.request_log == jb.request_log
    assert tb.tier_work == jb.tier_work
    assert tb.preempted_rids == jb.preempted_rids
    assert tb.migration_stats == jb.migration_stats
    assert tb.pool.telemetry() == jb.pool.telemetry()
    assert tb.pool.tier_telemetry() == jb.pool.tier_telemetry()
    assert tb.pool.in_use() == 0 and tb.reserved == 0 and tb.pool.audit()
    jtok, jmargin, ttok = streams
    diverged = assert_streams_match(jtok, jmargin, ttok)
    assert diverged <= len(jtok) // 2, "most streams must match in full"


@pytest.mark.parametrize("name", sorted(WORKLOADS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_paged_mode_matches_reference(weights, mode, name):
    workload, kw = WORKLOADS[name]
    jb, tb, streams = _run(weights, workload, **kw, **MODES[mode])
    assert not tb.fused and tb.stats["tick_dispatches_max"] >= 1
    _assert_same(jb, tb, streams)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_fused_and_unfused_streams_identical_in_port(weights, name):
    """One program, two dispatch schedules: the token streams, the work
    clock and the decode schedule are identical; only the launch count
    differs (the fused tick issues at most two per tick)."""
    _, tcfg, _, tparams, _ = weights
    workload, kw = WORKLOADS[name]
    runs = []
    for fused in (True, False):
        b = TBatcher(tcfg, params=tparams, device="cpu", fused=fused,
                     page_size=16, **kw)
        toks = capture_port(b)
        for p, mn, tier in workload:
            b.submit(p, max_new_tokens=mn, trust_tier=tier)
        b.run_until_done()
        runs.append((b, toks))
    (fb, ftok), (ub, utok) = runs
    assert ftok == utok
    assert fb.work_clock == ub.work_clock
    for key in ("ticks", "decode_steps", "decode_tokens", "share_hits",
                "prefix_tokens_skipped", "cow_copies"):
        assert fb.stats[key] == ub.stats[key], key
    assert fb.stats["tick_dispatches_max"] <= 2
    assert ub.stats["device_dispatches"] >= fb.stats["device_dispatches"]


@pytest.mark.parametrize("mode", ["fused", "unfused", "full"])
def test_oversubscribed_pool_preempts_like_reference(weights, mode):
    """Four decoders that each outgrow their share of a 5-page pool: the
    least-invested slot is preempted and requeued with a resume ticket,
    and every request completes with its full stream."""
    workload, kw = OVERSUBSCRIBED
    extra = {"fused": {}, "unfused": dict(fused=False),
             "full": dict(prefill="full")}[mode]
    jb, tb, streams = _run(weights, workload, **kw, **extra)
    assert tb.stats["preemptions"] > 0
    assert tb.migration_stats["recomputes"] > 0
    assert all(len(t) == 40 for t in streams[2].values())
    _assert_same(jb, tb, streams)
