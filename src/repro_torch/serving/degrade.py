"""Graceful-degradation vocabulary for the serving stack.

Three small, dependency-free pieces the rest of the stack shares:

* ``RejectReason`` — the ONE typed enum for every way a request can
  terminally fail: router-level rejections (``rate_limited``,
  ``infeasible``), executor-level rejections (``executor``,
  ``too_large``), the overload ladder (``shed``, ``backpressure``) and
  runtime SLO expiry (``expired``). It subclasses ``str`` so every
  existing ``decision.reason == "rate_limited"`` comparison keeps
  working; new code should compare against the enum members.
* ``OverloadPolicy`` — the engine's load-shedding watermarks. All
  watermarks default to ``None`` (disabled): an orchestrator without an
  explicit policy behaves bit-identically to one built before this
  module existed.
* ``FaultPlan`` / ``FaultEvent`` — the generalized scripted fault
  schedule. The churn benchmark scripted drains and kills as ad-hoc
  ``{tick: lambda orch: ...}`` dicts; the plan extends that vocabulary
  to deterministic slowdowns (work-clock multipliers), telemetry
  staleness, burst overload and mid-migration failures (a drain whose
  source dies while tickets are still in flight), while staying a plain
  data schedule a benchmark can print, diff and replay.

The degradation ladder the engine walks (docs/architecture.md,
"Degradation ladder & fault model"): watermarks -> shed -> expire ->
hedge -> fail.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional

# Deadline-to-work conversion: one millisecond of a request's declared
# ``deadline_ms`` buys this many deterministic work-clock units (tokens
# the mesh dispatches). Virtual wall time is not CI-gateable; the work
# clock is, so SLO enforcement budgets in work units.
SLO_WORK_PER_MS = 1.0


@dataclass(frozen=True)
class SLOClass:
    """A named service class: the unit of SLO-aware scheduling.

    Targets are in deterministic work-clock units (same clock as
    ``deadline_ms`` via ``SLO_WORK_PER_MS``), never wall time:

    * ``deadline_ms``       — per-request expiry budget applied at
      submit when the request doesn't carry its own deadline
    * ``ttft_work_target``  — work units from submit to first token
    * ``tpot_work_target``  — work units per generated token after the
      first (time-per-output-token)
    * ``priority``          — WAVES priority requests of this class
      inherit (feeds routing constraints and the shed ladder)

    ``math.inf`` disables a target; a class with no finite TTFT target
    (e.g. batch) gets urgency rank 0 and is the preferred preemption
    victim / last in class-aware admission order.
    """

    name: str
    deadline_ms: float = math.inf
    ttft_work_target: float = math.inf
    tpot_work_target: float = math.inf
    priority: str = "secondary"


def slo_rank_map(classes) -> dict:
    """Map class name -> integer urgency rank (higher = more urgent).

    Classes with a finite TTFT target are ranked by tightness (tightest
    target gets the highest rank, starting at 1); classes with no
    finite TTFT target rank 0 alongside unclassed requests. Ties in
    target share a deterministic order by name.
    """
    finite = sorted((c for c in classes if math.isfinite(c.ttft_work_target)),
                    key=lambda c: (-c.ttft_work_target, c.name))
    ranks = {c.name: 0 for c in classes}
    for i, c in enumerate(finite):
        ranks[c.name] = i + 1
    return ranks


class RejectReason(str, Enum):
    """Typed terminal-failure reasons, shared by ``engine.rejected``
    decisions, trace terminals and benchmark assertions."""

    RATE_LIMITED = "rate_limited"    # WAVES per-user token bucket
    INFEASIBLE = "infeasible"        # no island satisfies constraints
    EXECUTOR = "executor"            # batcher-level: could never fit
    TOO_LARGE = "too_large"          # context + owed tokens exceed pool
    SHED = "shed"                    # overload ladder: watermark shed
    BACKPRESSURE = "backpressure"    # saturation hint rejected at submit
    EXPIRED = "expired"              # work-clock SLO budget exhausted

    def __str__(self):               # str(Enum) would be the member repr
        return self.value


@dataclass(frozen=True)
class OverloadPolicy:
    """Watermark-gated load shedding with backpressure.

    ``None`` disables a watermark; the default policy disables all of
    them, so attaching no policy (or ``OverloadPolicy()``) changes
    nothing. When any configured watermark is crossed the engine sheds
    pending requests — lowest priority first, newest first within a
    priority — down to the queue watermark, instead of letting admission
    preemption thrash. Frozen migration tickets are never shed (a drain
    must not drop in-flight work).

    ``backpressure_pct`` gates the submit path: when the Lighthouse's
    hardened mesh-saturation hint (tier-scoped, quantized) meets it, new
    requests in ``shed_priorities`` are rejected at submit with
    ``RejectReason.BACKPRESSURE`` — WAVES backs off before routing ever
    sees the request.
    """

    queue_watermark: Optional[int] = None       # pending pool length
    backlog_watermark: Optional[int] = None     # mesh prefill-backlog toks
    occupancy_watermark: Optional[float] = None  # max island pool occupancy
    # priorities eligible for shedding/backpressure, least critical first
    shed_priorities: tuple = ("burstable", "secondary")
    backpressure_pct: Optional[int] = None      # hardened hint threshold

    def enabled(self) -> bool:
        return (self.queue_watermark is not None
                or self.backlog_watermark is not None
                or self.occupancy_watermark is not None)

    def shed_rank(self, priority: str) -> int:
        """Lower rank sheds first; priorities outside ``shed_priorities``
        (e.g. primary) rank above everything and are never shed."""
        try:
            return self.shed_priorities.index(priority)
        except ValueError:
            return len(self.shed_priorities)


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault at an orchestrator tick.

    Kinds:

    * ``drain``      — graceful evacuation (``island``; ``deregister``)
    * ``kill``       — abrupt island loss (``island``)
    * ``slowdown``   — work-clock multiplier ``factor`` on ``island``'s
      batcher: each unit of work takes ``factor`` ticks (factor 1 or
      ``recover`` restores full speed)
    * ``recover``    — clear a slowdown on ``island``
    * ``telemetry_stale`` — freeze (``on=True``) or resume (``on=False``)
      the Lighthouse's pool/migration telemetry intake: routing keeps
      running against the last published counters
    * ``burst``      — overload burst: call ``submit(orch)`` (the
      callback enqueues its requests; deterministic by construction)
    """

    tick: int
    kind: str
    island: Optional[str] = None
    factor: int = 1
    deregister: bool = False
    on: bool = True
    submit: Optional[Callable] = None


@dataclass
class FaultPlan:
    """A deterministic fault schedule applied against a
    ``TickOrchestrator``: call ``step(orch)`` once per tick, BEFORE
    ``orch.tick()``, mirroring how the churn benchmark fired its
    scripted events. ``applied`` records the events fired, in order, so
    a benchmark can assert the plan actually ran."""

    events: list = field(default_factory=list)
    applied: list = field(default_factory=list)
    _tick: int = 0

    def add(self, event: FaultEvent):
        self.events.append(event)
        return self

    def step(self, orch):
        t = self._tick
        self._tick += 1
        for ev in self.events:
            if ev.tick != t:
                continue
            self._apply(orch, ev)
            self.applied.append((t, ev.kind, ev.island))

    def _apply(self, orch, ev: FaultEvent):
        if ev.kind == "drain":
            orch.drain_island(ev.island, deregister=ev.deregister)
        elif ev.kind == "kill":
            orch.fail_island(ev.island)
        elif ev.kind == "slowdown":
            b = orch.batchers.get(ev.island)
            if b is not None:
                b.set_slowdown(ev.factor)
        elif ev.kind == "recover":
            b = orch.batchers.get(ev.island)
            if b is not None:
                b.set_slowdown(1)
        elif ev.kind == "telemetry_stale":
            orch.waves.lighthouse.stale = bool(ev.on)
        elif ev.kind == "burst":
            if ev.submit is not None:
                ev.submit(orch)
        else:
            raise ValueError(f"unknown fault kind {ev.kind!r}")

    def done(self) -> bool:
        return self._tick > max((e.tick for e in self.events), default=-1)
