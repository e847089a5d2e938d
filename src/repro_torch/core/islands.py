"""Computing islands (Definition 1) and the three-tier trust hierarchy.

An island is a computational resource with latency L_j, cost C_j, privacy
score P_j, trust T_j and time-varying capacity R_j(t). Tier 1 = personal
island group (Trust 1.0, MIST bypassed), Tier 2 = private edge (0.6-0.8),
Tier 3 = unbounded cloud (0.3-0.5, MIST mandatory).
"""
from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass, field, replace
from typing import Optional

from repro_torch.core.trust import compose_trust

TIER_PERSONAL = 1
TIER_PRIVATE_EDGE = 2
TIER_CLOUD = 3

# Island lifecycle (churn): ACTIVE islands take new work; DRAINING islands
# finish/migrate their in-flight work but are excluded from routing; FAILED
# islands are gone — their in-flight requests are stranded until the
# orchestrator requeues them. Status is registry state, not Island state:
# the Island dataclass is frozen and describes the resource, while
# lifecycle is an operational fact that changes at runtime.
STATUS_ACTIVE = "active"
STATUS_DRAINING = "draining"
STATUS_FAILED = "failed"

# paper Sec XI-B latency bands (ms): (min, max)
LATENCY_BANDS = {
    TIER_PERSONAL: (50.0, 500.0),
    TIER_PRIVATE_EDGE: (100.0, 1000.0),
    TIER_CLOUD: (200.0, 2000.0),
}


@dataclass(frozen=True)
class Island:
    island_id: str
    tier: int
    privacy: float                      # P_j, owner-declared
    cost_per_request: float             # C_j ($)
    latency_ms: float                   # L_j baseline round-trip + inference
    trust_base: float = 1.0             # T_base
    trust_cert: float = 1.0             # T_cert
    trust_jurisdiction: float = 1.0     # T_jurisdiction
    unbounded: bool = False             # HORIZON islands: infinite capacity
    capacity_units: float = 1.0         # relative compute capacity (bounded)
    models: tuple = ()                  # model ids this island can serve
    datasets: tuple = ()                # vector indices / RAG corpora present
    endpoint: str = "shore"             # "shore" (local exec) | "horizon"
    owner: str = "user"
    jurisdiction: str = "same_country"  # same_country | eu_gdpr | foreign

    def trust(self, mode: str = "min") -> float:
        return compose_trust(self.trust_base, self.trust_cert,
                             self.trust_jurisdiction, mode=mode)

    def __post_init__(self):
        assert 0.0 <= self.privacy <= 1.0
        assert self.tier in (TIER_PERSONAL, TIER_PRIVATE_EDGE, TIER_CLOUD)


class RegistrationError(Exception):
    pass


class IslandRegistry:
    """Island registration with attestation (Attack-2 mitigation).

    Registration requires a token derived from a shared owner secret (stand-in
    for device-bound certificates / mutual TLS); unauthenticated islands are
    rejected and never enter the mesh.
    """

    def __init__(self, secret: bytes = b"islandrun-demo-secret"):
        self._secret = secret
        self._islands: dict[str, Island] = {}
        self._status: dict[str, str] = {}
        self._teardown_hooks: list = []

    def attestation_token(self, island_id: str) -> str:
        return hmac.new(self._secret, island_id.encode(),
                        hashlib.sha256).hexdigest()

    def register(self, island: Island, token: Optional[str] = None) -> None:
        expected = self.attestation_token(island.island_id)
        if token is None or not hmac.compare_digest(token, expected):
            raise RegistrationError(
                f"island {island.island_id!r}: attestation failed")
        if not (0 <= island.privacy <= 1):
            raise RegistrationError("privacy score out of range")
        self._islands[island.island_id] = island
        self._status[island.island_id] = STATUS_ACTIVE

    def add_teardown_hook(self, fn) -> None:
        """Register ``fn(island_id)`` to run when an island deregisters.
        TIDE, LIGHTHOUSE and the orchestrator use this to drop their
        per-island state — without it, deregistration leaves load state,
        heartbeats, pool telemetry and batcher entries dangling."""
        self._teardown_hooks.append(fn)

    def deregister(self, island_id: str) -> None:
        if self._islands.pop(island_id, None) is None:
            return
        self._status.pop(island_id, None)
        for fn in self._teardown_hooks:
            fn(island_id)

    # ---------------------------------------------------------- lifecycle
    def status(self, island_id: str) -> str:
        """Lifecycle status; unknown islands report FAILED (an island that
        is not registered can never be routed to — fail closed)."""
        return self._status.get(island_id, STATUS_FAILED)

    def set_status(self, island_id: str, status: str) -> None:
        assert status in (STATUS_ACTIVE, STATUS_DRAINING, STATUS_FAILED)
        if island_id in self._islands:
            self._status[island_id] = status

    def is_routable(self, island_id: str) -> bool:
        """Only ACTIVE islands accept new work; draining islands finish
        what they hold, failed islands hold nothing."""
        return self.status(island_id) == STATUS_ACTIVE

    def get(self, island_id: str) -> Island:
        return self._islands[island_id]

    def all(self) -> list:
        return list(self._islands.values())

    def __len__(self):
        return len(self._islands)

    def __contains__(self, island_id):
        return island_id in self._islands


def personal_island(island_id: str, *, cost=0.0, latency_ms=100.0,
                    capacity_units=1.0, models=(), datasets=()):
    return Island(island_id, TIER_PERSONAL, privacy=1.0,
                  cost_per_request=cost, latency_ms=latency_ms,
                  trust_base=1.0, capacity_units=capacity_units,
                  models=models, datasets=datasets, endpoint="shore")


def edge_island(island_id: str, *, privacy=0.8, trust_cert=0.9,
                trust_jurisdiction=1.0, cost=0.001, latency_ms=300.0,
                capacity_units=4.0, models=(), datasets=()):
    return Island(island_id, TIER_PRIVATE_EDGE, privacy=privacy,
                  cost_per_request=cost, latency_ms=latency_ms,
                  trust_base=0.8, trust_cert=trust_cert,
                  trust_jurisdiction=trust_jurisdiction,
                  capacity_units=capacity_units, models=models,
                  datasets=datasets, endpoint="shore")


def cloud_island(island_id: str, *, privacy=0.4, cost=0.02,
                 latency_ms=800.0, models=(), trust_jurisdiction=0.6,
                 jurisdiction="foreign"):
    return Island(island_id, TIER_CLOUD, privacy=privacy,
                  cost_per_request=cost, latency_ms=latency_ms,
                  trust_base=0.5, trust_cert=0.7,
                  trust_jurisdiction=trust_jurisdiction, unbounded=True,
                  models=models, endpoint="horizon",
                  jurisdiction=jurisdiction)
