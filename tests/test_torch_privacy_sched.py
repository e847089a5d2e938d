"""The port's privacy-hardened scheduling (constant-shape dispatch and
per-tier quotas) held to the reference's, on the CPU.

Both packages' ``PagedContinuousBatcher`` serve the same workloads at
smollm-135m ``.reduced()`` with the reference's weights moved across by
``repro_torch.bridge``:

* ``constant_shape`` on tests/test_fused_tick.py's MIXED workload: the
  greedy streams, ``dispatch_shapes`` (tuple for tuple) and the work clock
  equal the reference's, and the streams equal the port's own default
  run; one prefill and one decode geometry. Exact equality holds here
  (the pinned rows and widths change no sum a logit depends on, in either
  package), so the margin rule of ``_torch_parity`` is not needed.
* the reference's validation errors, word for word where it words them;
* tests/test_degradation.py's two quota cases, plus the probe's timing
  equal to the reference's;
* quota runs (alone, with ``constant_shape``, with ``class_aware``, all
  three, and unfused): streams, ``request_log`` and ``dispatch_shapes``
  equal the reference's;
* ``build_island_batchers`` hands both options to every paged batcher.

The module runs under ``_torch_parity.lean_cpu`` (one torch thread; the
reference's batchers share their compiled steps).
"""
import jax
import pytest

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from repro.configs.base import get_config as jget_config
from repro.core.islands import IslandRegistry as JRegistry
from repro.core.islands import personal_island as jpersonal
from repro.models.model import get_model as jget_model
from repro.serving.batcher import PagedContinuousBatcher as JPaged
from repro.serving.batcher import make_batcher as jmake
from repro.serving.engine import build_island_batchers as jbuild
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.core.islands import IslandRegistry, personal_island
from repro_torch.serving.batcher import PagedContinuousBatcher, make_batcher
from repro_torch.serving.engine import build_island_batchers

pytestmark = pytest.mark.usefixtures("lean_cpu")
CPU = "cpu"
PREFIX = "shared clinical preamble for the cohort under review. "
MIXED = [
    (PREFIX + "alpha " * 12, 8, 0),
    (PREFIX + "beta " * 16, 6, 0),
    ("an unrelated billing request with no shared head", 8, 1),
    (PREFIX + "gamma " * 4, 10, 0),
    ("tiny", 5, None),
    (PREFIX + "delta " * 20, 7, 0),
]
# tiers 1 and 3 hold quotas, tiers 0 and None share what is left; the
# tier-1 load is heavy enough to be capped while tier 3 is admitted
TIERED = [
    ("tier one victim workload number zero " + "pad " * 18, 6, 1),
    ("tier one victim workload number one " + "pad " * 9, 5, 1),
    ("tier one victim workload number two " + "pad " * 25, 4, 1),
    ("adv probe 000", 3, 3),
    ("tier one victim workload number three", 6, 1),
    (PREFIX + "shared untiered " * 3, 5, None),
    ("adv probe 001 with a longer body " + "x" * 30, 4, 3),
    (PREFIX + "tier zero tail", 7, 0),
]


@pytest.fixture(scope="module")
def ref():
    jcfg = jget_config("smollm-135m").reduced()
    return jcfg, jget_model(jcfg).init(jax.random.PRNGKey(0), "float32")


@pytest.fixture(scope="module")
def cfg():
    return get_config("smollm-135m").reduced()


@pytest.fixture(scope="module")
def params(cfg, ref):
    return bridge.from_reference(cfg, jax.device_get(ref[1]))


def _serve(make, workload, ranks=None, **kw):
    """Submit ``workload`` ((prompt, max_new, tier) rows) to ``make(**kw)``
    and run it dry; ``ranks`` gives each request an SLO rank."""
    b = make(**kw)
    rids = [b.submit(p, max_new_tokens=mn, trust_tier=t)
            for p, mn, t in workload]
    for rid, r in zip(rids, ranks or ()):
        b.request_log[rid]["slo_rank"] = r
    done = b.run_until_done()
    return b, [done[r] for r in rids]


def _both(cfg, params, ref, workload, ranks=None, **kw):
    """The same run through the port and the reference batcher."""
    port = _serve(lambda **k: PagedContinuousBatcher(
        cfg, params=params, device=CPU, **k), workload, ranks, **kw)
    refr = _serve(lambda **k: JPaged(ref[0], params=ref[1], **k),
                  workload, ranks, **kw)
    return port, refr


# ------------------------------------------------------- constant shape

def test_constant_shape_matches_reference_on_mixed(cfg, params, ref):
    kw = dict(num_slots=3, max_len=96, page_size=16, fused=True)
    (bc, outc), (jc, joutc) = _both(cfg, params, ref, MIXED,
                                    constant_shape=True, **kw)
    (bf, outf), _ = _both(cfg, params, ref, MIXED, **kw)
    assert outc == joutc
    assert outc == outf
    assert bc.dispatch_shapes == jc.dispatch_shapes
    assert bc.work_clock == jc.work_clock == bf.work_clock
    pre = {s[1:] for s in bc.dispatch_shapes if s[0] == "prefill"}
    dec = {s[1:] for s in bc.dispatch_shapes if s[0] == "decode"}
    assert pre == {(3, bc._chunk_pages_canon, bc.pages_per_seq)}
    assert dec == {(3, bc.pages_per_seq)}
    assert len({s[1:] for s in bf.dispatch_shapes if s[0] == "prefill"}) > 1


def test_constant_shape_pins_prefill_rows_past_the_load(cfg, params, ref):
    """One short request on many slots: every prefill dispatch still
    carries ``num_slots`` rows (the padded ones write only the scratch
    page), and the stream is the default run's."""
    wl = [("one lonely request on a wide island", 6, 1)]
    kw = dict(num_slots=8, max_len=64, page_size=16)
    (bc, outc), (jc, joutc) = _both(cfg, params, ref, wl,
                                    constant_shape=True, **kw)
    (bf, outf), _ = _both(cfg, params, ref, wl, **kw)
    assert outc == joutc == outf
    assert bc.dispatch_shapes == jc.dispatch_shapes
    assert {s[1] for s in bc.dispatch_shapes if s[0] == "prefill"} == {8}
    assert {s[1] for s in bf.dispatch_shapes if s[0] == "prefill"} == {1}


@pytest.mark.parametrize("kw", [dict(fused=False),
                                dict(prefill="full")])
def test_constant_shape_requires_fused_chunked_path(cfg, ref, kw):
    msg = ("constant_shape requires the fused chunked-prefill path "
           r"\(fused=True, prefill='chunked'\)")
    with pytest.raises(ValueError, match=msg):
        PagedContinuousBatcher(cfg, num_slots=2, max_len=64, device=CPU,
                               constant_shape=True, **kw)
    with pytest.raises(ValueError, match=msg):
        JPaged(ref[0], num_slots=2, max_len=64, constant_shape=True, **kw)


# ------------------------------------------------------- per-tier quotas

@pytest.mark.parametrize("kw", [dict(tier_quotas={1: 3, 3: 2}),
                                dict(tier_quotas={1: 0}),
                                dict(prefill="full", tier_quotas={1: 2})])
def test_tier_quota_validation(cfg, params, ref, kw):
    """tests/test_degradation.py's three refusals (sum over the slots, a
    zero quota, full prefill), with the reference's wording."""
    errs = []
    for make, c, p, extra in ((make_batcher, cfg, params, {"device": CPU}),
                              (jmake, ref[0], ref[1], {})):
        with pytest.raises(ValueError) as e:
            make(c, cache="paged", params=p, num_slots=4, max_len=96,
                 **kw, **extra)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_tier_quota_isolates_probe_timing(cfg, params, ref):
    """The reference's case: with quotas, a tier-3 probe's (ttft, done)
    is invariant to co-resident tier-1 load; here also equal to the
    reference's, and the positive control (no quotas) moves."""
    def probe_timing(make, c, p, n_victims, extra, quotas):
        b = make(c, cache="paged", params=p, num_slots=4, max_len=96,
                 prefill_token_budget=16, tier_quotas=quotas, **extra)
        for k in range(n_victims):
            b.submit(f"tier one victim workload {k} with padding",
                     max_new_tokens=4, trust_tier=1)
        probe = b.submit("adv probe", max_new_tokens=3, trust_tier=3)
        b.run_until_done()
        rec = b.request_log[probe]
        return rec["ttft_ticks"], rec["done_tick"]

    for quotas in ({1: 2, 3: 2}, None):
        port = [probe_timing(make_batcher, cfg, params, n, {"device": CPU},
                             quotas) for n in (0, 2)]
        refr = [probe_timing(jmake, ref[0], ref[1], n, {}, quotas)
                for n in (0, 2)]
        assert port == refr
        assert (port[0] == port[1]) == (quotas is not None)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(constant_shape=True),
    dict(class_aware=True),
    dict(constant_shape=True, class_aware=True),
    dict(fused=False),
], ids=["quotas", "constant_shape", "class_aware", "all_three", "unfused"])
def test_tier_quota_run_matches_reference(cfg, params, ref, kw):
    """A mixed-tier workload under quotas {1: 2, 3: 2} on 6 slots with a
    32-token budget: streams, every ``request_log`` record and the
    dispatch geometry equal the reference's. Class-aware runs give the
    requests SLO ranks, so the quota scan's ``admissible`` filter meets
    the rank order (the highest rank among admissible entries, FCFS
    within a rank)."""
    ranks = [0, 2, 1, 0, 2, 1, 0, 2] if kw.get("class_aware") else None
    (b, out), (jb, jout) = _both(
        cfg, params, ref, TIERED, ranks, num_slots=6, max_len=128,
        prefill_token_budget=32, tier_quotas={1: 2, 3: 2}, **kw)
    assert out == jout
    assert all(o is not None and len(o) > 0 for o in out)
    assert b.request_log == jb.request_log
    assert b.dispatch_shapes == jb.dispatch_shapes
    assert b.work_clock == jb.work_clock
    assert b.stats["ticks"] == jb.stats["ticks"]
    if kw.get("constant_shape"):
        assert len({s[1:] for s in b.dispatch_shapes
                    if s[0] == "prefill"}) == 1


def test_queue_pick_filter_keeps_unfiltered_order(cfg, params):
    """``_queue_pick(admissible)`` skips only the entries it filters out:
    the unfiltered pick is FCFS (or the highest rank, FCFS within it)."""
    for class_aware in (False, True):
        b = PagedContinuousBatcher(cfg, params=params, num_slots=2,
                                   max_len=64, device=CPU,
                                   class_aware=class_aware)
        for k, (tier, rank) in enumerate([(1, 0), (3, 1), (1, 2), (3, 2),
                                          (None, 1)]):
            rid = b.submit(f"queued {k}", max_new_tokens=2,
                           trust_tier=tier)
            b.request_log[rid]["slo_rank"] = rank
        if class_aware:
            assert b._queue_pick() == 2
            assert b._queue_pick(lambda t: t == 3) == 3
            assert b._queue_pick(lambda t: t is None) == 4
        else:
            assert b._queue_pick() == 0
            assert b._queue_pick(lambda t: t == 3) == 1
            assert b._queue_pick(lambda t: t is None) == 4
        assert b._queue_pick(lambda t: False) is None


# --------------------------------------------------------- the mesh side

def test_build_island_batchers_passes_privacy_options(cfg, params, ref):
    """Both options reach every island's paged batcher, as in the
    reference, and a stacked mesh drops them."""
    def mesh(reg_cls, island, build, c, p, extra, cache="paged"):
        reg = reg_cls()
        for iid, cap in (("a", 2.0), ("b", 3.0)):
            reg.register(island(iid, latency_ms=20.0, capacity_units=cap),
                         reg.attestation_token(iid))
        return build(c, reg, cache=cache, params=p, max_len=96,
                     constant_shape=True, tier_quotas={1: 1, 3: 2},
                     **extra)

    port = mesh(IslandRegistry, personal_island, build_island_batchers,
                cfg, params, {"device": CPU})
    refr = mesh(JRegistry, jpersonal, jbuild, ref[0], ref[1], {})
    assert sorted(port) == sorted(refr)
    for iid, b in port.items():
        assert b.constant_shape and refr[iid].constant_shape
        assert b.tier_quotas == refr[iid].tier_quotas == {1: 1, 3: 2}
        assert b._const_caps == refr[iid]._const_caps
        assert b.num_slots == refr[iid].num_slots
    stacked = mesh(IslandRegistry, personal_island, build_island_batchers,
                   cfg, params, {"device": CPU}, cache="stacked")
    assert all(not hasattr(b, "tier_quotas") for b in stacked.values())
