"""The port's stacked ``ContinuousBatcher`` against the reference's, with
bridged weights, and the orchestrator over stacked batchers.

Every host integer is exactly equal: the deterministic stats (ticks,
decode steps, device dispatches, ...), the work clock and the
per-request lifecycle records. Token streams are compared under the
margin rule of ``_torch_parity`` (bf16 caches on a random-weight model
make greedy argmax fragile at near-ties, ROADMAP R1). The stacked cache
itself is compared row by row after the run: one bf16 ulp plus the
decode logits' 1e-3 (tests/test_torch_dense_model.py gives the reasons).
"""
import jax
import numpy as np
import pytest

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from _torch_parity import (assert_streams_match, capture_port,
                           capture_reference_host)
from repro.configs.base import get_config as jget_config
from repro.models.model import get_model as jget_model
from repro.serving.batcher import ContinuousBatcher as JBatcher
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.serving.batcher import ContinuousBatcher as TBatcher
from repro_torch.serving.batcher import make_batcher

# one torch thread, and the reference's step functions shared by
# every batcher of a config (``_torch_parity.lean_cpu``)
pytestmark = pytest.mark.usefixtures("lean_cpu")

PREFIX = "shared clinical preamble for the cohort under review. "
WORKLOADS = {
    "mixed": ([(PREFIX + "alpha " * 12, 8, 0), ("tiny", 5, None),
               ("an unrelated billing request with no shared head", 8, 1),
               (PREFIX + "gamma " * 4, 10, 0),
               (PREFIX + "delta " * 20, 7, 0)],
              dict(num_slots=3, max_len=96)),
    "queue_pressure": ([(f"request number {i} " + "filler " * (4 + 3 * i),
                         5, i % 3) for i in range(8)],
                       dict(num_slots=2, max_len=96)),
    "hits_max_len": ([("x" * 40, 30, 2), ("short prompt", 12, 1)],
                     dict(num_slots=2, max_len=64)),
}
EXACT_STATS = ("ticks", "admissions", "prefills", "prefill_dispatches",
               "device_dispatches", "tick_dispatches_max", "decode_steps",
               "decode_tokens", "queued_peak")


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("smollm-135m").reduced()
    tcfg = tget_config("smollm-135m").reduced()
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
    # the dense rows hold the last occupant's prompt and decoded K/V
    ref = jax.device_get(jb._cache)
    for si in range(kw["num_slots"]):
        want = bridge.dense_cache_from_reference(
            tcfg, jax.tree.map(lambda x: x[si], ref))
        if diverged:
            break                      # a stream parted: caches differ too
        for got_l, want_l in zip(tb._cache, want):
            for n in ("k", "v"):
                np.testing.assert_allclose(
                    got_l[n][si].float().numpy(),
                    want_l[n][0].float().numpy(), rtol=2 ** -7, atol=1e-3)


def test_make_batcher_stacked_drops_paged_options(weights):
    _, tcfg, _, tparams = weights
    b = make_batcher(tcfg, cache="stacked", params=tparams, num_slots=2,
                     max_len=64, page_size=16, num_pages=9, prefill="full",
                     prefill_token_budget=32, fused=False, sharing=False,
                     device="cpu")
    assert isinstance(b, TBatcher) and not hasattr(b, "pool")
    assert [tuple(t.shape) for t in b._cache[0].values()] == \
        [(2, 64, tcfg.num_kv_heads, tcfg.head_dim)] * 2
