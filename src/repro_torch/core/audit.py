"""Audit log (paper Sec XIV "Regulatory Compliance Verification").

Every routing decision is recorded as a structured, hash-chained entry —
enough for an auditor to verify (a) no request violated P_j >= s_r, (b)
every trust-boundary crossing was sanitized, (c) per-jurisdiction placement
counts — without storing raw query contents (only MIST scores, pattern
names and the decision metadata; the paper's ZK-proof variant is future
work, the hash chain gives tamper-evidence today)."""
from __future__ import annotations

import hashlib
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Optional


@dataclass
class AuditEntry:
    seq: int
    clock: float
    user: str
    sensitivity: float
    matched_patterns: tuple
    island_id: Optional[str]
    island_privacy: Optional[float]
    island_tier: Optional[int]
    accepted: bool
    reason: str
    sanitized: bool
    prev_hash: str
    entry_hash: str = ""


class AuditLog:
    def __init__(self):
        self.entries: list[AuditEntry] = []
        self._last_hash = "genesis"

    def record(self, req, decision, mist_report=None) -> AuditEntry:
        isl = decision.island
        e = AuditEntry(
            seq=len(self.entries),
            clock=time.time(),
            user=req.user,
            sensitivity=decision.sensitivity,
            matched_patterns=tuple(sorted({m[0] for m in
                                           (mist_report.matches if
                                            mist_report else [])})),
            island_id=isl.island_id if isl else None,
            island_privacy=isl.privacy if isl else None,
            island_tier=isl.tier if isl else None,
            accepted=decision.accepted,
            reason=decision.reason,
            sanitized=decision.sanitize,
            prev_hash=self._last_hash,
        )
        payload = json.dumps(asdict(e), sort_keys=True, default=str)
        e.entry_hash = hashlib.sha256(payload.encode()).hexdigest()
        self._last_hash = e.entry_hash
        self.entries.append(e)
        return e

    # ------------------------------------------------------- verification
    def verify_chain(self) -> bool:
        prev = "genesis"
        for e in self.entries:
            if e.prev_hash != prev:
                return False
            h = e.entry_hash
            e2 = AuditEntry(**{**asdict(e), "entry_hash": ""})
            payload = json.dumps(asdict(e2), sort_keys=True, default=str)
            if hashlib.sha256(payload.encode()).hexdigest() != h:
                return False
            prev = h
        return True

    def compliance_report(self) -> dict:
        viol = [e.seq for e in self.entries
                if e.accepted and e.island_privacy is not None
                and e.island_privacy < e.sensitivity and not e.sanitized]
        unsanitized_cloud = [e.seq for e in self.entries
                             if e.accepted and e.island_tier == 3
                             and not e.sanitized and e.sensitivity > 0.5]
        by_tier: dict = {}
        for e in self.entries:
            if e.accepted:
                by_tier[e.island_tier] = by_tier.get(e.island_tier, 0) + 1
        return {
            "entries": len(self.entries),
            "chain_valid": self.verify_chain(),
            "privacy_violations": viol,
            "unsanitized_sensitive_cloud": unsanitized_cloud,
            "placements_by_tier": by_tier,
            "rejected": sum(1 for e in self.entries if not e.accepted),
        }


class AuditedWAVES:
    """Decorator: WAVES with every decision recorded."""

    def __init__(self, waves, log: AuditLog | None = None):
        self.waves = waves
        self.log = log or AuditLog()

    def __getattr__(self, k):
        return getattr(self.waves, k)

    def route(self, req):
        rep = None
        if not getattr(self.waves.mist, "crashed", False):
            rep = self.waves.mist.analyze(req.query)
        d = self.waves.route(req)
        self.log.record(req, d, rep)
        return d
