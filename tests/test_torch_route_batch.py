"""The port's snapshot router ``route_batch`` and ``pareto_front`` against
the reference's (``repro/core/routing_jax.py``), on the same island
tables and requests.

Both packages pack the same mesh (tests/conftest.py's registry, with a
clinic dataset and a firm dataset) from their own copies of the islands
and TIDE; TIDE's loads are set to the same values on both sides so that
capacity gating bites. Requests are drawn with numpy from a seed:
sensitivities, capacity gates, deadlines, dataset ids (some -1) and
``personal_only`` flags. Assignments and feasibility are held to
equality, and so are the masked score matrices: at the default scales
the reference's jit divides by them as products with their float32
reciprocals, and the port takes the same products (a true division was
one ulp off in 6-13% of the scores), so both sides take the same float32
operations on the same float32 tables.
"""
import numpy as np
import pytest
import torch

from repro.core import islands as jisl
from repro.core import routing_jax as rj
from repro.core.tide import TIDE as JTIDE
from repro_torch.core import islands as tisl
from repro_torch.core import routing as tr
from repro_torch.core.tide import TIDE as TTIDE

MESH = [
    ("personal_island", "laptop", dict(latency_ms=120, capacity_units=3.0)),
    ("personal_island", "phone", dict(latency_ms=250, capacity_units=0.5)),
    ("edge_island", "home-nas", dict(privacy=0.9, latency_ms=300)),
    ("edge_island", "clinic-edge", dict(privacy=0.8, latency_ms=450,
                                        datasets=("medlit",),
                                        capacity_units=6.0)),
    ("edge_island", "firm-server", dict(privacy=1.0, trust_cert=1.0,
                                        latency_ms=350, capacity_units=8.0,
                                        datasets=("caselaw-10tb",))),
    ("cloud_island", "gpt4-api", dict(privacy=0.4, cost=0.02,
                                      latency_ms=900)),
    ("cloud_island", "cloud-api-2", dict(privacy=0.5, cost=0.015,
                                         latency_ms=800)),
]
DATASETS = ["medlit", "caselaw-10tb"]
# TIDE loads (cpu, gpu, mem) by island: the phone nearly full, the laptop
# half, the rest idle
LOADS = {"laptop": (0.5, 0.4, 0.3), "phone": (0.9, 0.95, 0.7),
         "home-nas": (0.2, 0.1, 0.1)}


def _tables(isl_mod, tide_cls, pack):
    reg = isl_mod.IslandRegistry()
    for kind, iid, kw in MESH:
        island = getattr(isl_mod, kind)(iid, **kw)
        reg.register(island, reg.attestation_token(iid))
    tide = tide_cls(reg)
    for iid, (c, g, m) in LOADS.items():
        st = tide._st(iid)
        st.cpu, st.gpu, st.mem = c, g, m
    return pack(reg.all(), DATASETS, tide)


@pytest.fixture(scope="module")
def tables():
    return (_tables(jisl, JTIDE, rj.pack_islands),
            _tables(tisl, TTIDE,
                    lambda *a: tr.pack_islands(*a, device="cpu")))


def _requests(seed, m):
    rng = np.random.default_rng(seed)
    return dict(
        sens=rng.uniform(0, 1, m).astype(np.float32),
        priority_gate=rng.choice([0.0, 0.2, 0.4, 0.6],
                                 m).astype(np.float32),
        deadline_ms=rng.choice([200.0, 400.0, 1000.0, np.inf],
                               m).astype(np.float32),
        dataset=rng.integers(-1, len(DATASETS), m).astype(np.int32),
        personal_only=rng.uniform(0, 1, m) < 0.2)


CASES = {
    "scalarized": dict(),
    "constraint": dict(mode="constraint"),
    "budget": dict(budget=0.016),
    "min_trust": dict(min_trust=0.9),
    "everything": dict(mode="constraint", budget=0.018, min_trust=0.5),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_route_batch_matches_reference(tables, case, seed):
    jtbl, ttbl = tables
    reqs = _requests(seed, 257)
    w = (0.4, 0.3, 0.3)
    ja, jf, js = rj.route_batch(jtbl, rj.pack_requests(**reqs), w,
                                **CASES[case])
    ta, tf, ts = tr.route_batch(ttbl, tr.pack_requests(**reqs), w,
                                **CASES[case])
    assert ta.dtype == torch.int32 and tf.dtype == torch.bool
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # both outcomes occur, and the dataset and personal-only masks bite
    assert tf.any() and not tf.all()


def test_route_batch_takes_weights_as_a_tensor(tables):
    _, ttbl = tables
    reqs = tr.pack_requests(**_requests(3, 64))
    w = (0.1, 0.7, 0.2)
    a, f, s = tr.route_batch(ttbl, reqs, w)
    b, g, t = tr.route_batch(ttbl, reqs, torch.tensor(w))
    assert torch.equal(a, b) and torch.equal(f, g) and torch.equal(s, t)


def test_snapshot_route_batch_oversubscribes_like_reference(tables):
    """tests/test_orchestrator.py's demo: the snapshot router sends the
    whole pool to the island that looked best at the snapshot, which the
    tick router does not."""
    jtbl, ttbl = tables
    m = 12
    reqs = dict(sens=np.full(m, 0.1, np.float32),
                priority_gate=np.full(m, 0.3, np.float32))
    w = np.asarray([0.4, 0.3, 0.3], np.float32)
    ja, _, _ = rj.route_batch(jtbl, rj.pack_requests(**reqs), w)
    ta, _, _ = tr.route_batch(ttbl, tr.pack_requests(**reqs),
                              torch.from_numpy(w))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert len(set(ta.tolist())) == 1


def test_pareto_front_matches_reference(tables):
    jtbl, ttbl = tables
    front = tr.pareto_front(ttbl)
    np.testing.assert_array_equal(front.numpy(),
                                  np.asarray(rj.pareto_front(jtbl)))
    objs = np.stack([ttbl.cost.numpy(), ttbl.latency.numpy(),
                     1 - ttbl.privacy.numpy()], 1)
    for j in range(len(objs)):
        dominated = any(
            np.all(objs[k] <= objs[j]) and np.any(objs[k] < objs[j])
            for k in range(len(objs)) if k != j)
        assert bool(front[j]) == (not dominated)
    assert bool(front[[m[1] for m in MESH].index("laptop")])
