"""The port's access-pattern privacy layer held to the reference's, on the
CPU: every case of tests/test_leakage.py run through the port's
``Lighthouse``, ``PagePool`` and ``AttackStack`` and, where the case
computes something, through the reference's too, with the results
compared exactly (telemetry is integer counting and value-keyed hashing;
attack accuracies are counts of classified trials).

The reference's two property tests take their examples from a seeded
numpy grid here instead of ``hypothesis`` (not installed on the test
machine), so they run rather than skip.

Added to the reference's cases, at smollm-135m ``.reduced()`` with the
reference's weights moved across by ``repro_torch.bridge``:

* the full seven-attack suite (``run_attack_suite`` at its defaults),
  mitigations off and on: each attack's ``AttackResult`` equals the
  reference's, off leaks (prefix >= 0.8, each attack >= chance + 0.25) and
  on sits at <= chance + 0.05, as benchmarks/leakage.py gates them;
* the traced leg: the mitigated suite with a ``Tracer`` on every stack
  gives the untraced accuracies exactly, and journals events;
* ``leakage_report`` of both suites equals the reference's.

The module runs under ``_torch_parity.lean_cpu`` (one torch thread; the
reference's batchers share their compiled steps).
"""
import jax
import numpy as np
import pytest

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from repro.configs.base import get_config as jget_config
from repro.core.islands import IslandRegistry as JRegistry
from repro.core.islands import personal_island as jpersonal
from repro.core.lighthouse import Lighthouse as JLighthouse
from repro.core.lighthouse import TelemetryPolicy as JPolicy
from repro.models.model import get_model as jget_model
from repro.privacy.adversary import AttackStack as JAttackStack
from repro.privacy.adversary import Mitigations as JMitigations
from repro.privacy.adversary import run_attack_suite as jrun_attack_suite
from repro.privacy.leakage import leakage_report as jleakage_report
from repro.serving.kvpool import PagePool as JPagePool
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.core.islands import IslandRegistry, personal_island
from repro_torch.core.lighthouse import Lighthouse, TelemetryPolicy
from repro_torch.obs import Tracer
from repro_torch.privacy import (CHANNEL_WEIGHTS, AttackResult, AttackStack,
                                 Mitigations, advantage, leakage_report,
                                 run_attack_suite)
from repro_torch.serving.kvpool import PagePool

pytestmark = pytest.mark.usefixtures("lean_cpu")
CPU = "cpu"
SLACK = 0.05             # benchmarks/leakage.py's constants
POSITIVE_MARGIN = 0.25
ATTACKS = {"prefix_membership", "victim_length_pages", "victim_length_work",
           "victim_length_backlog", "dispatch_shape", "island_routing",
           "scheduling_interference"}

PORT = dict(reg=IslandRegistry, island=personal_island, lh=Lighthouse,
            policy=TelemetryPolicy, pool=lambda **k: PagePool(device=CPU,
                                                              **k))
REF = dict(reg=JRegistry, island=jpersonal, lh=JLighthouse, policy=JPolicy,
           pool=lambda **k: JPagePool(**k))


def _exact(pkg):
    return pkg["policy"](noise=False, quantum_pages=1, quantum_tokens=1)


def _mesh(pkg, policy=None, n=2):
    reg = pkg["reg"]()
    for i in range(n):
        iid = f"isl{i}"
        reg.register(pkg["island"](iid), reg.attestation_token(iid))
    return pkg["lh"](reg, telemetry_policy=policy)


def _stats(tiers, **extra):
    """A synthetic report_pool payload with per-tier rows."""
    base = {"in_use": sum(d.get("pages_in_use", 0) for d in tiers.values()),
            "share_hits": 0, "prefill_backlog": 0, "work_clock": 123,
            "tiers": {t: dict({"pages_in_use": 0, "share_hits": 0,
                               "share_misses": 0, "prefill_backlog": 0,
                               "work": 0}, **d) for t, d in tiers.items()}}
    base.update(extra)
    return base


def _grid(n, *highs, seed=0):
    """``n`` seeded examples, column k drawn from 0..highs[k] (a bool
    column where highs[k] is None)."""
    rng = np.random.default_rng(seed)
    return [tuple(bool(rng.integers(2)) if h is None
                  else int(rng.integers(h + 1)) for h in highs)
            for _ in range(n)]


# ------------------------------------------------ tier-scoped lighthouse

def test_scoped_view_hides_more_sensitive_tiers():
    """A tier-3 viewer's aggregate must not move when tier-1 activity
    changes; a tier-1 viewer sees both tiers. Port = reference."""
    views = []
    for pkg in (PORT, REF):
        lh_a = _mesh(pkg, _exact(pkg))
        lh_b = _mesh(pkg, _exact(pkg))
        lh_a.report_pool("isl0", _stats({1: {"pages_in_use": 9},
                                         3: {"pages_in_use": 2}}))
        lh_b.report_pool("isl0", _stats({1: {"pages_in_use": 40},
                                         3: {"pages_in_use": 2}}))
        assert lh_a.pool_telemetry(viewer_tier=3) == \
            lh_b.pool_telemetry(viewer_tier=3)
        assert lh_a.pool_telemetry(viewer_tier=1)["pages_in_use"] == 11
        assert lh_b.pool_telemetry(viewer_tier=1)["pages_in_use"] == 42
        views.append([lh.pool_telemetry(viewer_tier=t)
                      for lh in (lh_a, lh_b) for t in (1, 3)])
    assert views[0] == views[1]


def test_scoped_view_omits_work_and_island_resolution():
    views = []
    for pkg in (PORT, REF):
        lh = _mesh(pkg, _exact(pkg))
        lh.report_pool("isl0", _stats({3: {"pages_in_use": 4,
                                           "work": 999}}))
        view = lh.pool_telemetry(viewer_tier=3)
        assert set(view) == {"viewer_tier", "pages_in_use", "share_hits",
                             "share_misses", "prefill_backlog"}
        views.append(view)
    assert views[0] == views[1]


def test_scoped_backlog_excludes_hidden_tiers():
    for pkg in (PORT, REF):
        lh = _mesh(pkg, _exact(pkg))
        lh.report_pool("isl0", _stats({1: {"prefill_backlog": 96},
                                       3: {"prefill_backlog": 32}},
                                      prefill_backlog=128))
        assert lh.mesh_prefill_backlog() == 128
        assert lh.mesh_prefill_backlog(viewer_tier=3) == 32
        assert lh.mesh_prefill_backlog(viewer_tier=1) == 128


def test_tier_scoped_off_degrades_to_raw_view():
    for pkg in (PORT, REF):
        lh = _mesh(pkg, pkg["policy"](tier_scoped=False))
        lh.report_pool("isl0", _stats({1: {"pages_in_use": 5}}))
        assert lh.pool_telemetry(viewer_tier=3) == lh.pool_telemetry()
        assert "isl0" in lh.pool_telemetry(viewer_tier=3)


@pytest.mark.parametrize("a,b,backlog", _grid(8, 50, 50, 30, seed=1))
def test_tier_aggregated_telemetry_is_exchangeable(a, b, backlog):
    """The scoped view is identical whichever same-tier victim produced
    the pages (default policy: scoped and noised); the raw per-island
    view exposes the swap. Port = reference, noise included."""
    seen = []
    for pkg in (PORT, REF):
        def mesh(x, y):
            lh = _mesh(pkg)
            lh.report_pool("isl0", _stats({1: {"pages_in_use": x,
                                               "prefill_backlog": backlog}}))
            lh.report_pool("isl1", _stats({1: {"pages_in_use": y}}))
            return lh

        lh1, lh2 = mesh(a, b), mesh(b, a)
        assert lh1.pool_telemetry(viewer_tier=1) == \
            lh2.pool_telemetry(viewer_tier=1)
        assert lh1.mesh_prefill_backlog(viewer_tier=1) == \
            lh2.mesh_prefill_backlog(viewer_tier=1)
        if a != b:
            assert lh1.pool_telemetry() != lh2.pool_telemetry()
        seen.append((lh1.pool_telemetry(viewer_tier=1),
                     lh1.mesh_prefill_backlog(viewer_tier=1)))
    assert seen[0] == seen[1]


@pytest.mark.parametrize("na,nb,swap", _grid(8, 6, 6, None, seed=2))
def test_pool_tier_telemetry_exchangeable_across_victims(na, nb, swap):
    """Per-tier pool counters cannot attribute pages to one same-tier
    victim: allocation order leaves ``tier_telemetry`` untouched."""
    seen = []
    for pkg in (PORT, REF):
        def drive(first, second):
            p = pkg["pool"](num_pages=16)
            for _ in range(first):
                p.alloc(tier=1)
            for _ in range(second):
                p.alloc(tier=1)
            p.alloc(tier=3)
            return p.tier_telemetry()

        assert drive(na, nb) == drive(nb, na)
        t = drive(na, nb) if not swap else drive(nb, na)
        if na + nb:
            assert t[1]["pages_in_use"] == na + nb
        seen.append(t)
    assert seen[0] == seen[1]


# --------------------------------------------------- value-keyed noising

def test_value_keyed_noise_is_deterministic_and_bounded():
    got = []
    for pkg in (PORT, REF):
        lh = _mesh(pkg)
        r1 = lh._report_value("pages_in_use", 9, 4, 3)
        assert r1 == lh._report_value("pages_in_use", 9, 4, 3)
        assert 12 <= r1 < 16
        assert lh._report_value("pages_in_use", 10, 4, 3) == r1
        assert lh._report_value("pages_in_use", 12, 4, 3) == r1
        got.append(r1)
    assert got[0] == got[1]


def test_noise_off_reports_quantized_truth():
    for pkg in (PORT, REF):
        lh = _mesh(pkg, pkg["policy"](noise=False))
        assert lh._report_value("pages_in_use", 9, 4, 3) == 12
        assert lh._report_value("pages_in_use", 0, 4, 3) == 0


# ------------------------------------------------------------ the scorer

def test_advantage_normalization():
    assert advantage(1.0, 0.5) == 1.0
    assert advantage(0.5, 0.5) == 0.0
    assert advantage(0.3, 0.5) == 0.0
    assert advantage(0.625, 0.25) == 0.5


def test_leakage_report_weights_and_lps():
    res = {
        "a": AttackResult(name="a", signal="hit_rate", n_classes=2,
                          chance=0.5, accuracy=1.0, n_test=4),
        "b": AttackResult(name="b", signal="backlog", n_classes=4,
                          chance=0.25, accuracy=0.25, n_test=8),
    }
    rep = leakage_report(res)
    by = {s["attack"]: s for s in rep["per_signal"]}
    assert by["a"]["advantage"] == 1.0
    assert by["a"]["risk"] == CHANNEL_WEIGHTS["hit_rate"]
    assert by["b"]["advantage"] == 0.0
    w = CHANNEL_WEIGHTS["hit_rate"] + CHANNEL_WEIGHTS["backlog"]
    assert rep["lps"] == pytest.approx(CHANNEL_WEIGHTS["hit_rate"] / w)
    assert rep == jleakage_report(res)


# ------------------------------------------------- end-to-end (reduced)

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


def test_mitigated_observation_exposes_no_island_or_work(cfg, params, ref):
    stack = AttackStack(cfg, params, Mitigations.on(), device=CPU)
    obs = stack.observe()
    assert obs["per_island_pages"] == {} and obs["work"] == 0
    assert obs == JAttackStack(ref[0], ref[1], JMitigations.on()).observe()


def test_prefix_membership_attack_blunted_by_mitigations(cfg, params, ref):
    off = run_attack_suite(cfg, params, Mitigations.off(),
                           include={"prefix_membership"}, test_per_class=1,
                           device=CPU)
    on = run_attack_suite(cfg, params, Mitigations.on(),
                          include={"prefix_membership"}, test_per_class=1,
                          device=CPU)
    assert off["prefix_membership"].accuracy >= 0.8
    assert on["prefix_membership"].accuracy <= 0.5 + 0.05


@pytest.fixture(scope="module")
def suites(cfg, params, ref):
    """The full suite at its defaults through both packages, mitigations
    off and on, and the port's mitigated suite traced."""
    out = {}
    for label in ("off", "on"):
        out[label] = (
            run_attack_suite(cfg, params, getattr(Mitigations, label)(),
                             device=CPU),
            jrun_attack_suite(ref[0], ref[1],
                              getattr(JMitigations, label)()))
    tracer = Tracer()
    out["traced"] = (run_attack_suite(cfg, params, Mitigations.on(),
                                      tracer=tracer, device=CPU), tracer)
    return out


@pytest.mark.parametrize("label", ["off", "on"])
def test_attack_suite_matches_reference(suites, label):
    port, refr = suites[label]
    assert set(port) == set(refr) == ATTACKS
    for name in ATTACKS:
        p, j = port[name], refr[name]
        assert (p.name, p.signal, p.n_classes, p.chance, p.accuracy,
                p.n_test) == (j.name, j.signal, j.n_classes, j.chance,
                              j.accuracy, j.n_test), name
    if label == "off":
        assert port["prefix_membership"].accuracy >= 0.8
        assert all(r.accuracy >= r.chance + POSITIVE_MARGIN
                   for r in port.values())
    else:
        assert all(r.accuracy <= r.chance + SLACK for r in port.values())


def test_traced_suite_equals_untraced(suites):
    traced, tracer = suites["traced"]
    on = suites["on"][0]
    assert sorted(traced) == sorted(on)
    assert all(traced[k].accuracy == on[k].accuracy for k in on)
    assert all(r.accuracy <= r.chance + SLACK for r in traced.values())
    assert len(tracer.events) > 0


@pytest.mark.parametrize("label", ["off", "on"])
def test_leakage_report_of_the_suite(suites, label):
    port, refr = suites[label]
    rep = leakage_report(port)
    assert rep == jleakage_report(refr)
    assert [s["attack"] for s in rep["per_signal"]] == sorted(ATTACKS)
    assert rep["lps"] == (1.0 if label == "off" else 0.0)
