"""Request-span tracer: a deterministic event journal for the serving
stack.

Every event carries the three-clock stamp (orchestrator/batcher tick,
deterministic work-clock units, wall-clock ns) plus a kind and free-form
attributes. Emission is a dict append — no device sync, no allocation
beyond the event itself — so tracing is zero-interference by
construction: token streams and the work clock are bit-identical with a
tracer attached or not (gated in ``benchmarks/serving.py``).

Event kinds, by scope:

* batcher scope (``island`` set by ``attach_tracer``): ``queue``,
  ``thaw_queue``, ``admit``, ``prefill`` (one per chunk-run dispatch,
  ``tokens`` = work dispatched), ``first_token``, ``decode`` (one per
  fused decode dispatch, ``rids`` = slots that advanced one token),
  ``preempt``, ``freeze``, ``finish``, ``exec_reject``, ``expire``
  (work-clock SLO budget blown mid-execution), and the KV-pool
  events ``page_alloc`` / ``page_cow`` / ``page_share``;
* orchestrator scope (``island=None``): ``submit``, ``route_tick``
  (per-island TIDE capacity snapshot), ``route`` (chosen island +
  score), ``dispatch`` / ``dispatch_sim``, ``migrate_out`` /
  ``migrate_in`` / ``migrate_return``, ``failover``, ``restart``,
  ``complete``, ``reject``, ``expire``.

**Trust boundary.** The raw event stream is operator-view only — the
same boundary as the Lighthouse's ``viewer_tier=None`` telemetry: it
names islands, requests and per-request work, all of which the scoped
tenant view deliberately withholds. The ONLY tenant-visible projection
is ``tenant_summary``, which reduces the journal to mesh-wide aggregate
counts over tiers the viewer may see and pushes every value through the
mesh ``TelemetryPolicy`` hardening (``lighthouse.harden_value``).

Self-validation (the CI gates ride these):

* ``work_by_island`` — per-request dispatched work, per island; its sum
  must equal each batcher's ``work_clock`` (span conservation: every
  work-clock unit is attributed to exactly one request);
* ``terminal_counts`` — orchestrator-level ``complete``/``reject``/
  ``expire`` events per rid; exactly one per submitted request, even
  across the drain/kill churn scenarios.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class TraceEvent:
    kind: str
    island: Optional[str]        # None = orchestrator scope
    rid: Optional[int]           # batcher-local or orchestrator rid
    tick: int                    # scheduling tick (scope-local clock)
    work: int                    # deterministic work clock at emission
    wall_ns: int                 # perf_counter_ns; profiling only
    seq: int                     # global emission order
    attrs: dict = field(default_factory=dict)


# orchestrator-scope kinds that resolve a request exactly once
TERMINAL_KINDS = ("complete", "reject", "expire")


class Tracer:
    """Append-only event journal shared by one serving stack (an
    orchestrator plus its island batchers, or a standalone batcher)."""

    def __init__(self):
        self.events: list[TraceEvent] = []
        self._seq = 0

    def __len__(self):
        return len(self.events)

    def emit(self, kind: str, *, island: Optional[str] = None,
             rid: Optional[int] = None, tick: int = 0, work: int = 0,
             wall_ns: Optional[int] = None, **attrs):
        ev = TraceEvent(
            kind=kind, island=island, rid=rid, tick=int(tick),
            work=int(work),
            wall_ns=(time.perf_counter_ns() if wall_ns is None
                     else int(wall_ns)),
            seq=self._seq, attrs=attrs)
        self.events.append(ev)
        self._seq += 1
        return ev

    # ------------------------------------------------------- selection
    def by_kind(self, *kinds: str) -> list:
        want = set(kinds)
        return [e for e in self.events if e.kind in want]

    def islands(self) -> list:
        return sorted({e.island for e in self.events
                       if e.island is not None})

    # -------------------------------------------------- self-validation
    def work_by_island(self) -> dict:
        """{island: {rid: work}} — every dispatched work-clock unit,
        attributed to the request that consumed it: ``prefill`` events
        carry their token count, each rid in a ``decode`` event's row
        list advanced exactly one token."""
        out: dict = {}
        for e in self.events:
            if e.island is None:
                continue
            per = out.setdefault(e.island, {})
            if e.kind == "prefill" and e.rid is not None:
                per[e.rid] = per.get(e.rid, 0) + int(e.attrs["tokens"])
            elif e.kind == "decode":
                for rid in e.attrs.get("rids", ()):
                    per[rid] = per.get(rid, 0) + 1
        return out

    def conservation_ok(self, batchers: dict) -> dict:
        """Span conservation per island: the per-request work sums must
        reproduce each batcher's ``work_clock`` exactly. ``batchers``
        maps island id -> batcher (pass dead islands' batchers too —
        their journal stops where their clock froze, so the identity
        holds for them as well). Returns per-island booleans plus
        ``all``."""
        attributed = self.work_by_island()
        out = {}
        for iid, b in batchers.items():
            got = sum(attributed.get(iid, {}).values())
            out[iid] = (got == b.work_clock)
        out["all"] = all(out.values()) if out else True
        return out

    def terminal_counts(self) -> dict:
        """{rid: count} over orchestrator-scope terminal events."""
        counts: dict = {}
        for e in self.events:
            if e.island is None and e.kind in TERMINAL_KINDS \
                    and e.rid is not None:
                counts[e.rid] = counts.get(e.rid, 0) + 1
        return counts

    def terminals_exactly_once(self, rids) -> bool:
        """Every submitted rid resolved exactly once (no drops, no
        double completions) — the churn-scenario gate."""
        counts = self.terminal_counts()
        return all(counts.get(r, 0) == 1 for r in rids) \
            and all(r in set(rids) for r in counts)

    def first_token_counts(self) -> dict:
        """{(island, rid): count} of ``first_token`` events — exactly
        one per request per batcher it reached pre-first-token (a thaw
        that already holds its token emits none)."""
        counts: dict = {}
        for e in self.events:
            if e.kind == "first_token":
                key = (e.island, e.rid)
                counts[key] = counts.get(key, 0) + 1
        return counts

    # ---------------------------------------------------- tenant view
    def tenant_summary(self, policy, viewer_tier: int) -> dict:
        """The ONLY tenant-visible projection of the journal: mesh-wide
        event counts over trust tiers the viewer may see (tier' >=
        viewer_tier, matching the lighthouse's scoped view), hardened
        through the mesh ``TelemetryPolicy`` (round-up quantum +
        value-keyed noise). No islands, no rids, no clocks, no work —
        cumulative work deltas re-expose per-request timing even when
        aggregated, so they never cross this boundary."""
        from repro_torch.core.lighthouse import harden_value

        def visible(e):
            t = e.attrs.get("tier")
            return isinstance(t, int) and t >= viewer_tier

        counts = {"requests_completed": 0, "pages_allocated": 0}
        for e in self.events:
            if e.kind == "finish" and visible(e):
                counts["requests_completed"] += 1
            elif e.kind == "page_alloc" and visible(e):
                counts["pages_allocated"] += 1
        q = policy.quantum_pages
        return {"viewer_tier": viewer_tier,
                **{k: harden_value(policy, f"trace_{k}", v, q, viewer_tier)
                   for k, v in counts.items()}}
