"""paligemma-3b and musicgen-large served by the port against the
reference, at ``.reduced()`` widths with bridged weights, on every path
the reference picks for them.

``make_batcher(cache="auto")`` gives both the paged pool (attention only,
no window), so the main path is the fused chunked paged batcher, whose
chunk mode applies no prefix-LM mask in either package: the reference's
default path attends paligemma's prefix causally (ROADMAP R8). Its
stacked batcher, its paged ``prefill="full"`` batcher and its
per-request server prefill in ``mode="full"``, which attends the prefix
both ways. Each path is compared with the same path of the reference:

* every deterministic host integer is equal (stats, work clock, dispatch
  geometry, lifecycle records, pool telemetry);
* streams are equal under the margin rule of ``_torch_parity`` (ROADMAP
  R1: bf16 K/V on a random-weight model make greedy argmax fragile at
  near-ties).

The prompts run past the reduced prefix of 8 tokens, so the prefix mask
bites on the full-mode paths; ``test_prefix_separates_the_paths`` shows
that it does, in both packages alike. ``PagePool.check`` is the
reference's alias of ``audit`` (ROADMAP F2). The module builds batchers
in both packages, so it runs under ``lean_cpu``.
"""
import jax
import numpy as np
import pytest
import torch

import repro.serving.engine as jengine
import repro_torch.serving.engine as tengine
from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from _torch_parity import (assert_streams_match, capture_port,
                           capture_reference, capture_reference_host,
                           reference_steps)
from repro.configs.base import get_config as jget_config
from repro.models.model import get_model as jget_model
from repro.serving.batcher import ContinuousBatcher as JStacked
from repro.serving.batcher import PagedContinuousBatcher as JPaged
from repro.serving.batcher import make_batcher as jmake_batcher
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.serving.batcher import ContinuousBatcher as TStacked
from repro_torch.serving.batcher import PagedContinuousBatcher as TPaged
from repro_torch.serving.batcher import make_batcher
from test_torch_per_request import _record_reference

pytestmark = pytest.mark.usefixtures("lean_cpu")

HEAD = "shared clinical preamble for the cohort under review. "
WORKLOAD = [
    (HEAD + "alpha " * 12, 8, 0),
    ("an unrelated billing request with no shared head", 8, 1),
    ("tiny", 5, None),
    (HEAD + "gamma " * 4, 6, 0),
]
KW = dict(num_slots=3, max_len=96)
EXACT_STATS = ("ticks", "admissions", "prefills", "prefill_dispatches",
               "device_dispatches", "tick_dispatches_max", "decode_steps",
               "decode_tokens", "queued_peak")
PAGED_STATS = ("prefix_tokens_skipped", "share_hits", "cow_copies",
               "prefill_chunk_tokens", "stalls", "preemptions")


@pytest.fixture(scope="module", params=["paligemma-3b", "musicgen-large"])
def weights(request, lean_cpu):
    jcfg = jget_config(request.param).reduced()
    tcfg = tget_config(request.param).reduced()
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), "float32")
    tparams = bridge.from_reference(tcfg, jax.device_get(jparams))
    return jcfg, tcfg, jparams, tparams, reference_steps(jmodel)


def _serve(jb, tb, steps=None):
    """Serve the workload on both; ``steps`` (the reference's jitted fused
    steps) for a fused paged pair, None for host-sampled batchers."""
    if steps is not None:
        jtok, jmargin = capture_reference(jb, steps)
    else:
        jtok, jmargin = capture_reference_host(jb)
    ttok = capture_port(tb)
    for p, mn, tier in WORKLOAD:
        assert jb.submit(p, max_new_tokens=mn, trust_tier=tier) == \
            tb.submit(p, max_new_tokens=mn, trust_tier=tier)
    jdone, tdone = jb.run_until_done(), tb.run_until_done()
    assert sorted(jdone) == sorted(tdone) == list(range(len(WORKLOAD)))
    assert all(t is not None for t in tdone.values())
    assert tb.work_clock == jb.work_clock
    stats = EXACT_STATS + (PAGED_STATS if hasattr(tb, "pool") else ())
    for key in stats:
        assert tb.stats[key] == jb.stats[key], key
    assert tb.request_log == jb.request_log
    assert tb.tier_work == jb.tier_work
    if hasattr(tb, "pool"):
        assert tb.dispatch_shapes == jb.dispatch_shapes
        assert tb.pool.telemetry() == jb.pool.telemetry()
        assert tb.pool.in_use() == 0 and tb.pool.check()
    diverged = assert_streams_match(jtok, jmargin, ttok)
    assert diverged <= len(jtok) // 2, "most streams must match in full"
    return ttok


def test_auto_cache_is_the_paged_pool(weights):
    jcfg, tcfg, jparams, tparams, _ = weights
    assert isinstance(jmake_batcher(jcfg, cache="auto", params=jparams),
                      JPaged)
    tb = make_batcher(tcfg, cache="auto", params=tparams, device="cpu")
    assert isinstance(tb, TPaged) and tb.fused and tb.prefill_mode == \
        "chunked"


def test_main_path_matches_reference(weights):
    """The fused chunked paged batcher (K2 prefill, K1 decode)."""
    jcfg, tcfg, jparams, tparams, steps = weights
    jb = JPaged(jcfg, params=jparams, page_size=16, **KW)
    tb = TPaged(tcfg, params=tparams, device="cpu", page_size=16, **KW)
    _serve(jb, tb, steps)


@pytest.mark.parametrize("path", ["stacked", "paged_prefill_full"])
def test_full_mode_paths_match_reference(weights, path):
    """The paths that prefill in ``mode="full"`` (K4 with the prefix),
    then decode causally (K3 on the stacked cache, K1 on the pool)."""
    jcfg, tcfg, jparams, tparams, _ = weights
    if path == "stacked":
        jb = JStacked(jcfg, params=jparams, **KW)
        tb = TStacked(tcfg, params=tparams, device="cpu", **KW)
    else:
        jb = JPaged(jcfg, params=jparams, page_size=16, prefill="full",
                    **KW)
        tb = TPaged(tcfg, params=tparams, device="cpu", page_size=16,
                    prefill="full", **KW)
    _serve(jb, tb)


def test_per_request_server_matches_reference(weights):
    """``LocalModelServer.generate``: one full-mode prefill of a padded
    batch into a dense cache, then greedy decode (ROADMAP R5's padding
    reproduced as is)."""
    jcfg, tcfg, jparams, tparams, _ = weights
    js = jengine.LocalModelServer(jcfg, params=jparams, max_len=96)
    ts = tengine.LocalModelServer(tcfg, params=tparams, max_len=96,
                                  device="cpu")
    margins = _record_reference(js)
    prompts = [WORKLOAD[0][0], WORKLOAD[1][0]]
    _, jtoks = js.generate(prompts, max_new_tokens=6)
    _, ttoks = ts.generate(prompts, max_new_tokens=6)
    assert ttoks.shape == jtoks.shape == (2, 6)
    assert_streams_match(
        {r: [int(t) for t in jtoks[r]] for r in range(2)}, margins,
        {r: [int(t) for t in ttoks[r]] for r in range(2)})


def test_prefix_separates_the_paths(weights):
    """The first token's logits of one prompt through the chunked paged
    path (causal prefix) and the full-mode path (prefix both ways): each
    path's row agrees across the packages (1e-3, the bf16-page decode
    tolerance of tests/test_torch_bridge_model.py), and the two paths
    part by the same gap in both (ROADMAP R8)."""
    jcfg, tcfg, jparams, tparams, _ = weights
    rows = {}
    for pkg, cls, cfg, params, dev in (
            ("jax", JPaged, jcfg, jparams, {}),
            ("torch", TPaged, tcfg, tparams, {"device": "cpu"})):
        for mode in ("chunked", "full"):
            b = cls(cfg, params=params, page_size=16, prefill=mode,
                    fused=False, num_slots=1, max_len=96, **dev)
            seen = {}
            if mode == "full":
                prefill = b._prefill

                def pre(p, c, inputs, prefill=prefill, seen=seen):
                    out = prefill(p, c, inputs)
                    seen["row"] = np.asarray(out[0][0], np.float32)
                    return out
                b._prefill = pre
            else:
                dispatch = b._dispatch_chunks

                def chunks(si, group, b=b, dispatch=dispatch, seen=seen):
                    logits = dispatch(si, group)
                    s = b.slots[si]
                    if s.next_chunk == len(s.chunks):
                        off = (s.prompt_len - 1) - group[0][0] * b.page_size
                        seen["row"] = np.asarray(logits[0, off], np.float32)
                    return logits
                b._dispatch_chunks = chunks
            b.submit(WORKLOAD[0][0], max_new_tokens=1, trust_tier=0)
            b.run_until_done()
            rows[pkg, mode] = seen["row"]
    for mode in ("chunked", "full"):
        np.testing.assert_allclose(rows["torch", mode], rows["jax", mode],
                                   rtol=1e-3, atol=1e-3)
    gap = np.abs(rows["torch", "full"] - rows["torch", "chunked"]).max()
    ref_gap = np.abs(rows["jax", "full"] - rows["jax", "chunked"]).max()
    # both packages part their two paths by the same gap (measured 4e-6
    # apart). Without a prefix the gap is the chunk path's bf16 pages
    # against full mode's fresh fp32 K/V (musicgen: 0.0069); the prefix
    # adds the keys the causal mask hides (paligemma: 0.065)
    assert abs(gap - ref_gap) < 1e-4
    assert gap > 0.03 if tcfg.prefix_lm else gap < 0.02


def test_page_pool_check_is_audit(weights):
    """ROADMAP F2: ``check()`` is ``audit()`` on a pool in use, as in the
    reference, mid-run and after it drains."""
    _, tcfg, _, tparams, _ = weights
    tb = TPaged(tcfg, params=tparams, device="cpu", page_size=16, **KW)
    for p, mn, tier in WORKLOAD:
        tb.submit(p, max_new_tokens=mn, trust_tier=tier)
    tb.tick()
    tb.tick()
    assert tb.pool.in_use() > 0
    assert tb.pool.check() is tb.pool.audit() is True
    tb.pool._free.append(tb.pool._free[0])         # a duplicated free page
    with pytest.raises(AssertionError, match="free list dup"):
        tb.pool.check()
    tb.pool._free.pop()
    tb.run_until_done()
    assert tb.pool.check() == tb.pool.audit()
    assert torch.is_tensor(tb.pool.pages[0]["k_pages"])
