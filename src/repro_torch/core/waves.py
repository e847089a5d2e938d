"""WAVES — multi-objective router (paper Sec VI, Algorithm 1).

Pipeline per request: MIST sensitivity -> TIDE capacity -> privacy filter
(P_j >= s_r, fail-closed) -> data-locality/model/budget filters -> composite
score S = w1*C + w2*L + w3*(1-P) -> argmin -> trust-boundary sanitization.

Also implements:
  * constraint-based alternative (Sec VI-C): hard filters then min latency
  * policy knobs: on_infeasible reject|queue_local, budget ceiling,
    min-trust requirement, trust composition mode
  * per-user token-bucket rate limiting (Attack-4 mitigation)
  * the four baselines from Sec XI-A (cloud-only / local-only /
    latency-greedy / privacy-only) behind the same interface
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.islands import TIER_PERSONAL, TIER_CLOUD
from repro_torch.core.placeholder import PlaceholderStore
# the shared terminal-failure vocabulary (a str-enum: every historical
# string comparison against these reasons still holds). repro.serving is
# a namespace package and degrade has no repro imports, so this cannot
# cycle back into core.
from repro_torch.serving.degrade import RejectReason


@dataclass
class Request:
    query: str
    modality: str = "text"
    deadline_ms: float = math.inf          # d_r
    history: tuple = ()                    # h_r (chat context)
    priority: str = "secondary"            # primary|secondary|burstable
    dataset: Optional[str] = None          # data-locality requirement
    model: Optional[str] = None            # required model family
    user: str = "user0"
    prev_privacy: float = 1.0              # P of island holding the context
    sensitivity_override: Optional[float] = None
    slo_class: Optional[str] = None        # SLO service class name (the
                                           # engine resolves it against its
                                           # registered SLOClass table)


@dataclass
class Policy:
    w_cost: float = 0.4                    # w1
    w_latency: float = 0.3                 # w2
    w_privacy: float = 0.3                 # w3
    on_infeasible: str = "reject"          # "reject" (fail-closed) |
                                           # "queue_local" (Alg 1 line 11)
    budget_per_request: Optional[float] = None
    min_trust: float = 0.0
    trust_mode: str = "min"
    mode: str = "scalarized"               # "scalarized" | "constraint"
    rate_limit_per_s: float = math.inf
    # Sec XIV regulatory routing: None = anywhere; else islands must declare
    # one of these jurisdictions (e.g. ("same_country", "eu_gdpr") for GDPR)
    allowed_jurisdictions: Optional[tuple] = None
    # cost normalization for the scalarized score ($ at which w1 saturates)
    cost_scale: float = 0.05
    latency_scale_ms: float = 2000.0


@dataclass
class Decision:
    island: Optional[object]               # selected Island or None
    accepted: bool
    reason: str
    sensitivity: float
    score: Optional[float] = None
    sanitize: bool = False
    sanitized_history: Optional[tuple] = None
    placeholder_store: Optional[PlaceholderStore] = None
    scores: dict = field(default_factory=dict)
    n_candidates: int = 0


class RateLimiter:
    """Token bucket per user (Attack 4: island flooding)."""

    def __init__(self, rate_per_s: float, burst: float = 10.0):
        self.rate = rate_per_s
        self.burst = burst
        self.tokens: dict[str, float] = {}
        self.last: dict[str, float] = {}

    def allow(self, user: str, now: float) -> bool:
        if math.isinf(self.rate):
            return True
        t = self.tokens.get(user, self.burst)
        t = min(self.burst, t + (now - self.last.get(user, now)) * self.rate)
        self.last[user] = now
        if t >= 1.0:
            self.tokens[user] = t - 1.0
            return True
        self.tokens[user] = t
        return False


class WAVES:
    def __init__(self, mist, tide, lighthouse, policy: Policy | None = None,
                 seed: int = 0):
        self.mist = mist
        self.tide = tide
        self.lighthouse = lighthouse
        self.policy = policy or Policy()
        self._limiter = RateLimiter(self.policy.rate_limit_per_s)
        self._seed = seed
        self._session = 0
        # Sec IV extensibility: (name, score_fn(request, island)->[0,1], w)
        self._extra_agents: list = []

    def register_agent(self, name: str, score_fn, weight: float):
        """Add a new optimization objective WITHOUT modifying the router
        (paper Sec IV: 'WAVES automatically incorporates f into Eq. (1)')."""
        self._extra_agents.append((name, score_fn, weight))

    # ------------------------------------------------------------ scoring
    def composite_score(self, island, request=None) -> float:
        """S(r, i_j) = w1*C_j + w2*L_j + w3*(1-P_j), Eq. (1), with C and L
        normalized to [0,1] so user weights are unit-comparable; registered
        extension agents contribute additional weighted terms."""
        p = self.policy
        c = min(island.cost_per_request / p.cost_scale, 1.0)
        l = min(self.tide.effective_latency_ms(island) / p.latency_scale_ms,
                1.0)
        s = (p.w_cost * c + p.w_latency * l
             + p.w_privacy * (1.0 - island.privacy))
        for _, fn, w in self._extra_agents:
            s += w * fn(request, island)
        return s

    def _eligible(self, island, req, s_r) -> Optional[str]:
        """None if eligible, else the rejection reason."""
        p = self.policy
        if island.privacy < s_r:
            return "privacy"                        # hard constraint
        if req.priority == "primary" and island.tier != TIER_PERSONAL:
            # Sec IX-B: primary executes locally regardless of pressure
            return "primary_local_only"
        if req.dataset and req.dataset not in island.datasets:
            return "data_locality"
        if req.model and island.models and req.model not in island.models:
            return "model"
        if p.budget_per_request is not None and \
                island.cost_per_request > p.budget_per_request:
            return "budget"
        if island.trust(p.trust_mode) < p.min_trust:
            return "trust"
        if island.latency_ms > req.deadline_ms:
            return "deadline"
        if p.allowed_jurisdictions is not None and \
                island.jurisdiction not in p.allowed_jurisdictions:
            return "jurisdiction"
        if not self.tide.admits(island.island_id, req.priority):
            return "capacity"
        return None

    # ------------------------------------------------------------ routing
    def route(self, req: Request) -> Decision:
        if not self._limiter.allow(req.user, self.tide.clock):
            return Decision(None, False, RejectReason.RATE_LIMITED, -1.0)
        rep = self.mist.analyze(req.query)
        s_r = (req.sensitivity_override
               if req.sensitivity_override is not None else rep.score)

        candidates = []
        rejects = {}
        for island in self.lighthouse.get_islands():
            why = self._eligible(island, req, s_r)
            if why is None:
                candidates.append(island)
            else:
                rejects[island.island_id] = why

        if not candidates:
            if self.policy.on_infeasible == "queue_local":
                local = [i for i in self.lighthouse.get_islands()
                         if i.tier == TIER_PERSONAL and i.privacy >= s_r]
                if local:
                    best = min(local,
                               key=lambda i: self.composite_score(i, req))
                    return self._finish(req, best, s_r, "queued_local")
            return Decision(None, False, RejectReason.INFEASIBLE, s_r,
                            scores={"rejects": rejects})

        if self.policy.mode == "constraint":
            best = min(candidates, key=self.tide.effective_latency_ms)
        else:
            best = min(candidates,
                       key=lambda i: self.composite_score(i, req))
        return self._finish(req, best, s_r, "routed",
                            n_candidates=len(candidates))

    def _finish(self, req, island, s_r, reason, n_candidates=1,
                account_load=True) -> Decision:
        # account_load=False: the batched tick router (core.routing_jax.
        # route_batch_tick) has already accounted the load inside its greedy
        # pass and written it back to TIDE; only the sanitize/session logic
        # runs here.
        # trust-boundary transition (Def. 4): sanitize history when moving
        # to a lower-privacy island; Tier 3 is always sanitized; the
        # personal group (P=1.0) bypasses MIST entirely.
        needs_sanitize = (
            island.tier != TIER_PERSONAL
            and (island.privacy < req.prev_privacy
                 or island.tier == TIER_CLOUD))
        store = None
        hist = tuple(req.history)
        if needs_sanitize and (req.history or req.query):
            self._session += 1
            texts, store = self.mist.sanitize(
                list(req.history) + [req.query],
                seed=self._seed + self._session)
            hist = tuple(texts)
        score = self.composite_score(island, req)
        if account_load:
            self.tide.add_load(island.island_id, work=1.0)
        return Decision(island, True, reason, s_r,
                        score=score,
                        sanitize=needs_sanitize,
                        sanitized_history=hist if needs_sanitize else None,
                        placeholder_store=store,
                        n_candidates=n_candidates)


# --------------------------------------------------------------- baselines

class BaselineRouter:
    """Sec XI-A baselines behind the WAVES interface."""

    def __init__(self, kind: str, mist, tide, lighthouse):
        assert kind in ("cloud_only", "local_only", "latency_greedy",
                        "privacy_only")
        self.kind = kind
        self.mist = mist
        self.tide = tide
        self.lighthouse = lighthouse

    def route(self, req: Request) -> Decision:
        rep = self.mist.analyze(req.query)
        s_r = rep.score
        islands = self.lighthouse.get_islands()
        if not islands:
            return Decision(None, False, "no_islands", s_r)
        if self.kind == "cloud_only":
            cands = [i for i in islands if i.tier == TIER_CLOUD]
        elif self.kind == "local_only":
            cands = [i for i in islands if i.tier == TIER_PERSONAL
                     and self.tide.admits(i.island_id, req.priority)]
        elif self.kind == "latency_greedy":
            cands = [i for i in islands
                     if self.tide.admits(i.island_id, req.priority)]
            cands = sorted(cands,
                           key=self.tide.effective_latency_ms)[:1]
        else:  # privacy_only
            best_p = max(i.privacy for i in islands)
            cands = [i for i in islands if i.privacy == best_p
                     and self.tide.admits(i.island_id, req.priority)]
        if not cands:
            return Decision(None, False, "infeasible", s_r)
        best = min(cands, key=self.tide.effective_latency_ms)
        self.tide.add_load(best.island_id, work=1.0)
        # baselines do NOT sanitize — that's the point of the comparison
        return Decision(best, True, "routed", s_r)
