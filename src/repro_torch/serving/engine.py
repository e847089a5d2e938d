"""Inference engine: WAVES routing wired to island executors.

Port of ``repro/serving/engine.py``. Two serving frontends share the
executors and metrics:

* ``InferenceEngine`` — the per-request loop: each ``submit()`` routes one
  request through scalar WAVES and runs a one-shot
  ``LocalModelServer.generate()`` (full-prompt prefill into a dense cache,
  then greedy decode) on a SHORE island.
* ``TickOrchestrator`` — the throughput path: ``submit()`` only enqueues;
  each scheduling ``tick()`` routes the whole pending pool in ONE
  ``route_batch_tick`` pass on the orchestrator's device (capacity-aware
  within the tick), dispatches SHORE work into per-island batchers
  (stacked or paged) and HORIZON work as virtual-time simulated
  completions, runs the batchers, feeds KV-pool pressure back into TIDE
  and the Lighthouse, and drains finished sequences through MIST
  desanitization.

Time is virtual: the per-request engine advances the TIDE/Lighthouse
clocks by each submit's service latency (network model plus measured
execution time), the orchestrator by a fixed interval per tick.

Island churn: ``TickOrchestrator.drain_island`` takes an island out of
routing and freezes its in-flight requests, up to
``migration_token_budget`` context tokens a tick, into migration tickets
that the next routing pass places (KV pages move only to an island at
least as trusted as their tier; otherwise the destination recomputes from
tokens; with nowhere to go a ticket returns to its source under a capped
backoff); TIDE-flagged stragglers are evacuated the same way.
``fail_island`` drops an island and requeues everything it held from the
prompt.

Degradation, SLO classes and fairness: every tick first expires the
requests whose work-clock budget (``deadline_ms``, or their SLO class's)
the monotonic mesh work clock has passed, at any stage (queued, frozen,
in a batcher, simulated), then sheds the newest lowest-priority pending
requests once the ``OverloadPolicy`` watermarks are crossed; ``submit``
bounces sheddable priorities while the Lighthouse's hardened saturation
hint is at the policy's threshold. ``slo_classes`` give requests their
deadline and an urgency rank for class-aware batchers; ``slo_aware``
lets the classes steer (ranks and SLO lag fed to TIDE) or only be
counted (``slo_report``); ``fair_tenancy`` orders each tick's routing
pool round-robin across tenants, least served first. A ``Tracer``
journals every submit, route, dispatch, migration, failover and
terminal, and every batcher's spans (``serving.batcher``);
``debug_audit`` checks every paged pool's invariants at every tick.

Not ported yet: constant-shape dispatch and per-tier quotas (ROADMAP
Queue 1, P10); ``build_island_batchers`` refuses both by name.
"""
from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import routing as rt
from repro_torch.core.islands import STATUS_DRAINING, STATUS_FAILED
from repro_torch.core.tide import MIGRATION_TOKENS_PER_UNIT
from repro_torch.core.waves import Decision, Request
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.model import get_model, resolve_device
from repro_torch.models.steps import make_prefill_step, make_serve_step
from repro_torch.obs.metrics import jain_index, latency_summary, percentile
from repro_torch.serving.degrade import (SLO_WORK_PER_MS, OverloadPolicy,
                                         RejectReason, slo_rank_map)
from repro_torch.serving.kvpool import trust_tier_for_sensitivity
from repro_torch.serving.migration import MigrationTicket, ticket_fits

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the ticks ``submit_sync`` waits for one request before it gives up
_SYNC_MAX_TICKS = 10_000

# Capped exponential backoff for failed migration placements: the first
# failure waits BASE ticks before the request may freeze and retry, each
# further failure doubles the wait up to CAP; a change of the routable
# island set clears every backoff.
BACKOFF_BASE_TICKS = 16
BACKOFF_CAP_TICKS = 256

# Trust tier through which the engine reads the Lighthouse's hardened
# mesh-saturation hint for submit-time backpressure: the least-trusted
# view, so admission control never sees sharper load data than any
# tenant could.
BACKPRESSURE_VIEWER_TIER = 3


@dataclass
class Response:
    text: str
    island_id: str
    latency_ms: float
    cost: float
    sensitivity: float
    sanitized: bool
    decision: Decision
    tokens: Optional[list] = None
    # the serving island's declared privacy, snapshotted at completion
    island_privacy: Optional[float] = None


class LocalModelServer:
    """A small real model served on a SHORE island: batched full-prompt
    prefill + greedy decode against a dense cache, on ``device`` (None =
    the card).

    A batch of prompts is padded AFTER its tokens with id 0, and every
    prompt's first token comes from position L-1 of the longest one, so a
    shorter prompt is conditioned on padding — as in the reference, whose
    ``InferenceEngine`` always sends one prompt."""

    def __init__(self, cfg, params=None, seed=0, max_len=256,
                 dtype="float32", device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = get_model(cfg)
        self.params = params if params is not None else self.model.init(
            seed, _DTYPES[dtype], self.device)
        self.max_len = max_len
        self.tok = ByteTokenizer(cfg.vocab_size)
        self._prefill = make_prefill_step(self.model)
        self._decode = make_serve_step(self.model)

    def generate(self, prompts, max_new_tokens=16):
        """Returns (texts, tokens (B, max_new_tokens) int array); the
        tokens cross to the host once, at the end."""
        B = len(prompts)
        enc = [self.tok.encode(p)[: self.max_len - max_new_tokens]
               for p in prompts]
        L = max(len(e) for e in enc)
        toks = np.zeros((B, L), np.int32)
        for i, e in enumerate(enc):
            toks[i, :len(e)] = e  # left-aligned; pad id 0
        cache = self.model.init_cache(B, self.max_len, dtype=torch.bfloat16,
                                      device=self.device)
        logits, cache = self._prefill(
            self.params, cache, torch.from_numpy(toks).to(self.device))
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        outs = [tok[:, 0]]
        for pos in range(L, L + max_new_tokens - 1):
            logits, cache = self._decode(self.params, cache, tok, pos)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            outs.append(tok[:, 0])
        gen = torch.stack(outs, 1).cpu().numpy()  # (B, T)
        return [self.tok.decode(list(g)) for g in gen], gen


class CloudSimulator:
    """HORIZON executor: canned echo responses (placeholder-aware) with a
    latency/queueing model."""

    def __init__(self, seed=0):
        self.rng = random.Random(seed)

    def complete(self, island, query: str) -> tuple:
        words = [w for w in query.split() if w.startswith("[") or len(w) > 6]
        ref = words[0] if words else "that"
        text = (f"Regarding {ref}: here is a detailed answer from "
                f"{island.island_id}.")
        jitter = self.rng.uniform(0.8, 1.4)
        return text, island.latency_ms * jitter


class InferenceEngine:
    def __init__(self, waves, registry, local_servers=None, seed=0):
        """local_servers: {island_id: LocalModelServer} for SHORE islands."""
        self.waves = waves
        self.registry = registry
        self.local = local_servers or {}
        self.cloud = CloudSimulator(seed)
        self.log: list[Response] = []
        self.rejected: list[Decision] = []

    def submit(self, req: Request, max_new_tokens=12) -> Optional[Response]:
        d = self.waves.route(req)
        if not d.accepted:
            self.rejected.append(d)
            return None
        island = d.island
        query = (d.sanitized_history[-1] if d.sanitize
                 else req.query)
        t0 = time.perf_counter()
        if island.island_id in self.local:
            texts, toks = self.local[island.island_id].generate(
                [query], max_new_tokens)
            text = texts[0]
            exec_ms = (time.perf_counter() - t0) * 1000.0
        else:
            text, latency = self.cloud.complete(island, query)
            exec_ms = latency
        if d.sanitize and d.placeholder_store is not None:
            text = self.waves.mist.desanitize(text, d.placeholder_store)
        # advance virtual time by the simulated service latency
        dt = (island.latency_ms + exec_ms) / 1000.0
        self.waves.tide.advance(dt)
        self.waves.lighthouse.advance(dt)
        for isl in self.registry.all():
            self.waves.lighthouse.heartbeat(isl.island_id)
        resp = Response(text=text, island_id=island.island_id,
                        latency_ms=island.latency_ms + exec_ms,
                        cost=island.cost_per_request,
                        sensitivity=d.sensitivity, sanitized=d.sanitize,
                        decision=d, island_privacy=island.privacy)
        self.log.append(resp)
        return resp

    # ----------------------------------------------------------- metrics
    def stats(self):
        return aggregate_stats(self.log, self.rejected, self.registry)


def aggregate_stats(log, rejected, registry):
    """Shared serving metrics: counts, cost, latency percentiles, privacy
    accounting and the per-island distribution."""
    n = len(log)
    if n == 0:
        return {"n": 0, "rejected": len(rejected)}
    by_island = {}
    for r in log:
        by_island[r.island_id] = by_island.get(r.island_id, 0) + 1

    def _privacy(r):
        if r.island_privacy is not None:
            return r.island_privacy
        if r.island_id in registry:
            return registry.get(r.island_id).privacy
        return 0.0       # island gone, no snapshot: count it (fail closed)
    viol = sum(1 for r in log if r.sensitivity > _privacy(r))
    return {
        "n": n,
        "rejected": len(rejected),
        "cost_total": sum(r.cost for r in log),
        **latency_summary(r.latency_ms for r in log),
        "privacy_violations": viol,
        "sanitized": sum(1 for r in log if r.sanitized),
        "by_island": by_island,
    }


@dataclass
class PendingRequest:
    rid: int
    req: Request
    max_new_tokens: int
    submitted_at: float        # virtual clock at submission
    # set while the request is between islands: the frozen in-flight state
    # a drain evacuated, consumed (and cleared) at the next dispatch, plus
    # the decision it was running under (so the draining source can finish
    # it if no destination will take it)
    ticket: Optional[MigrationTicket] = None
    decision: Optional[Decision] = None
    # SLO budget: the monotonic mesh work-clock reading past which this
    # request expires (inf = no deadline), set once at submit and carried
    # through freezes and migrations
    deadline_work: float = math.inf


class TickOrchestrator:
    """Batched scheduling-tick serving loop.

    ``submit()`` enqueues; every ``tick()``:

    1. packs the pending pool and routes it in ONE ``route_batch_tick``
       pass — the greedy pass decrements bounded-island capacity per
       assignment, so a single tick cannot oversubscribe an island — and
       writes the final TIDE state back;
    2. dispatches accepted SHORE requests into that island's batcher and
       HORIZON requests as simulated async completions;
    3. runs up to ``decode_ticks_per_tick`` batcher ticks per island,
       completes finished sequences through MIST desanitization and
       reports pool pressure and telemetry;
    4. advances the virtual clocks by ``tick_interval_s`` and releases
       simulated completions whose latency has elapsed.

    Before routing, each tick services island churn (``drain_island``,
    TIDE-flagged stragglers): frozen requests join the pool with their
    migration tickets and are placed by the same pass; then it expires
    blown SLO budgets, sheds overload and, with ``fair_tenancy``, orders
    the pool across tenants.

    Routing runs on ``device`` (None = the card); its results cross to
    the host once per tick.
    """

    def __init__(self, waves, registry, batchers=None, seed=0,
                 decode_ticks_per_tick=4, tick_interval_s=0.05,
                 migration_token_budget=512, tracer=None, overload=None,
                 debug_audit=False, slo_classes=None, slo_aware=True,
                 fair_tenancy=False, device=None):
        self.waves = waves
        self.registry = registry
        self.batchers = batchers or {}
        self.device = resolve_device(device)
        # optional span tracer (repro_torch.obs.Tracer): orchestrator
        # events carry island=None; every island batcher is attached
        # under its island id. Pure observation.
        self.tracer = tracer
        if tracer is not None:
            for iid, b in self.batchers.items():
                b.attach_tracer(tracer, island=iid)
        self.cloud = CloudSimulator(seed)
        self.decode_ticks_per_tick = decode_ticks_per_tick
        self.tick_interval_s = tick_interval_s
        # context tokens (KV + generated) a single tick may evacuate from
        # draining islands; the rest keeps decoding at the source and moves
        # on later ticks
        self.migration_token_budget = migration_token_budget
        self.pending: list[PendingRequest] = []
        self.results: dict[int, Optional[Response]] = {}
        self._local_inflight: dict[tuple, tuple] = {}
        self._sim_inflight: list = []
        self.log: list[Response] = []
        self.rejected: list[Decision] = []
        self._next_rid = 0
        self._util_sum: dict[str, float] = {}
        self._util_n: dict[str, int] = {}
        self._draining: dict[str, bool] = {}     # island -> dereg on empty
        # failed-placement backoff: rid -> (attempts, retry_at_tick)
        self._placement_backoff: dict[int, tuple] = {}
        self._last_routable: tuple = ()
        # overload ladder (load shedding + submit backpressure); the
        # default policy disables every watermark
        self.overload = overload or OverloadPolicy()
        # end-of-tick PagePool.audit() on every paged batcher
        self.debug_audit = debug_audit
        # monotonic mesh work clock: per-island work_clock deltas
        # accumulated across churn (an island failure drops its batcher
        # clock; this counter never goes backwards): the clock SLO
        # deadlines are enforced against
        self.mesh_work = 0
        self._work_seen: dict[str, int] = {}
        self.tick_stats = {"ticks": 0, "route_calls": 0, "routed": 0,
                           "decode_ticks": 0, "pool_peak": 0,
                           "admissions": 0, "prefill_dispatches": 0,
                           "device_dispatches": 0, "tick_dispatches_max": 0,
                           "migrations_started": 0, "migrations": 0,
                           "recomputes": 0, "pages_shipped": 0,
                           "restarts": 0, "failovers": 0,
                           "migration_returns": 0, "islands_drained": 0,
                           "expired": 0, "shed": 0, "hedges": 0,
                           "backpressure_rejects": 0,
                           "fairness_min_jain": 1.0}
        # SLO classes: name -> SLOClass. A tagged request inherits its
        # class's deadline (a finite request-level deadline wins) and its
        # urgency rank for class-aware batchers. slo_aware=False keeps the
        # classes for accounting but stops them from influencing any
        # scheduling decision (the A/B arm of the trace harness).
        self.slo_classes: dict = dict(slo_classes or {})
        self.slo_aware = slo_aware
        self._slo_ranks = slo_rank_map(self.slo_classes.values())
        self.class_log = {name: {"ttft_work": [], "tpot_work": [],
                                 "completed": 0, "expired": 0,
                                 "shed": 0, "rejected": 0}
                          for name in self.slo_classes}
        # per-tenant work-clock service (prompt tokens computed +
        # generated tokens) and the tenants that ever entered the pool;
        # fair_tenancy=True also orders each tick's routing pool to
        # interleave tenants, least served first
        self.fair_tenancy = fair_tenancy
        self.tenant_service: dict[str, int] = {}
        self._tenant_seen: set = set()
        hook = getattr(registry, "add_teardown_hook", None)
        if hook is not None:
            hook(self._on_island_deregistered)

    def _otrace(self, kind, rid=None, **attrs):
        """Orchestrator-scope span event: tick = orchestrator tick, work
        = the sum of the LIVE batchers' work clocks (an island failure
        drops its clock, so this stamp is not monotonic across churn)."""
        if self.tracer is not None:
            # an "island" kwarg here is an attribute (e.g. the chosen
            # route target): orchestrator events keep scope island=None
            island_attr = attrs.pop("island", None)
            ev = self.tracer.emit(kind, island=None, rid=rid,
                                  tick=self.tick_stats["ticks"],
                                  work=sum(b.work_clock
                                           for b in self.batchers.values()),
                                  **attrs)
            if island_attr is not None:
                ev.attrs["island"] = island_attr

    # --------------------------------------------------------- submission
    def submit(self, req: Request, max_new_tokens=12) -> int:
        """Enqueue; returns a request id resolved in ``results`` once the
        request completes (None if rejected, shed, bounced by
        backpressure, or expired)."""
        rid = self._next_rid
        self._next_rid += 1
        p = PendingRequest(rid, req, max_new_tokens, self.waves.tide.clock)
        deadline_ms = req.deadline_ms
        if not math.isfinite(deadline_ms):
            # no deadline of its own: inherit the SLO class's
            cls = self._class_of(req)
            if cls is not None:
                deadline_ms = cls.deadline_ms
        if math.isfinite(deadline_ms):
            # the deadline becomes a work-clock budget at admission
            p.deadline_work = self.mesh_work \
                + deadline_ms * SLO_WORK_PER_MS
        if self.tracer is not None:
            self._otrace("submit", rid=rid, priority=req.priority,
                         max_new=max_new_tokens)
        # submit-time backpressure: sheddable priorities bounce while the
        # mesh-saturation hint (read through the LEAST-trusted telemetry
        # view) sits at or above the policy threshold
        pol = self.overload
        if pol.backpressure_pct is not None \
                and pol.shed_rank(req.priority) < len(pol.shed_priorities) \
                and self.waves.lighthouse.mesh_saturation(
                    viewer_tier=BACKPRESSURE_VIEWER_TIER) \
                >= pol.backpressure_pct:
            d = Decision(None, False, RejectReason.BACKPRESSURE, -1.0)
            self.rejected.append(d)
            self.results[rid] = None
            self.tick_stats["backpressure_rejects"] += 1
            self._class_count(req, "rejected")
            self._otrace("reject", rid=rid,
                         reason=str(RejectReason.BACKPRESSURE))
            return rid
        self._tenant_seen.add(req.user)
        self.pending.append(p)
        self.tick_stats["pool_peak"] = max(self.tick_stats["pool_peak"],
                                           len(self.pending))
        return rid

    def submit_sync(self, req: Request,
                    max_new_tokens=12) -> Optional[Response]:
        """Blocking submit for session/chat callers: ticks until this
        request resolves, or gives up after ``_SYNC_MAX_TICKS``."""
        rid = self.submit(req, max_new_tokens)
        ticks = 0
        while rid not in self.results and ticks < _SYNC_MAX_TICKS:
            self.tick()
            ticks += 1
        return self.results.get(rid)

    # ------------------------------------------ SLO classes and fairness
    def _class_of(self, req):
        """The request's SLOClass, or None when untagged/unregistered."""
        if req.slo_class is None:
            return None
        return self.slo_classes.get(req.slo_class)

    def _slo_rank(self, req) -> int:
        """Urgency rank forwarded to class-aware batchers (0 = none);
        always 0 when slo_aware is off."""
        if not self.slo_aware or req.slo_class is None:
            return 0
        return self._slo_ranks.get(req.slo_class, 0)

    def _class_count(self, req, outcome: str):
        log = self.class_log.get(req.slo_class) if req.slo_class else None
        if log is not None:
            log[outcome] += 1

    def _account_completion(self, req, rec):
        """Fold a finished request's batcher log record into the
        per-class TTFT/TPOT histograms and the tenant service clock.
        ``rec`` is None on the simulated-cloud path (no batcher log): the
        tenant is still credited a nominal unit."""
        work = 1
        if rec is not None:
            work = max(1, rec.get("prompt_tokens", 0)
                       - rec.get("tokens_skipped", 0)
                       + rec.get("generated_tokens", 0))
        self.tenant_service[req.user] = \
            self.tenant_service.get(req.user, 0) + work
        log = self.class_log.get(req.slo_class) if req.slo_class else None
        if log is None:
            return
        log["completed"] += 1
        if rec is None or "ttft_work" not in rec:
            return
        log["ttft_work"].append(rec["ttft_work"])
        if "done_work" in rec:
            # decode work past the first token, per decode token (the
            # formula of obs.metrics.collect_batcher_metrics)
            span = rec["done_work"] - rec["submit_work"] - rec["ttft_work"]
            toks = max(rec.get("generated_tokens", 0) - 1, 1)
            log["tpot_work"].append(span / toks)

    def _fair_order(self, pool):
        """Deterministic fair-queueing order for the tick's routing pool:
        each tenant's k-th queued request sorts into round k, rounds break
        ties by accumulated work-clock service (least served first), then
        rid."""
        nth: dict = {}
        rounds = {}
        for p in pool:
            k = nth.get(p.req.user, 0)
            nth[p.req.user] = k + 1
            rounds[p.rid] = k
        pool.sort(key=lambda p: (rounds[p.rid],
                                 self.tenant_service.get(p.req.user, 0),
                                 p.rid))

    def _report_slo_pressure(self):
        """Feed per-island SLO lag into TIDE's queueing term: for every
        in-flight request whose class has a finite work-clock target, the
        overshoot past that target (TTFT while queued or prefilling, TPOT
        once decoding) sums into a lag the router prices as extra queue
        depth on that island. Reads host bookkeeping only (a fused slot's
        device-resident tokens are counted by ``gen_dev``)."""
        lags: dict = {}
        for (iid, brid), (p, _d) in self._local_inflight.items():
            cls = self._class_of(p.req)
            if cls is None:
                continue
            b = self.batchers.get(iid)
            if b is None:
                continue
            rec = b.request_log.get(brid)
            if rec is None or "outcome" in rec:
                continue
            if "ttft_work" not in rec:
                if math.isfinite(cls.ttft_work_target):
                    lag = (b.work_clock - rec["submit_work"]) \
                        - cls.ttft_work_target
                    if lag > 0.0:
                        lags[iid] = lags.get(iid, 0.0) + lag
            elif math.isfinite(cls.tpot_work_target):
                toks = None
                for s in b.slots:
                    if s.active and s.request_id == brid:
                        toks = len(s.generated) + s.gen_dev
                        break
                if not toks:
                    continue
                elapsed = b.work_clock - rec["submit_work"] \
                    - rec["ttft_work"]
                lag = elapsed - max(toks - 1, 1) * cls.tpot_work_target
                if lag > 0.0:
                    lags[iid] = lags.get(iid, 0.0) + lag
        for iid, lag in sorted(lags.items()):
            self.waves.tide.report_slo_lag(iid, lag)

    def _snapshot_fairness(self):
        """Per-tick min-Jain snapshot over tenants that have entered the
        pool, sampled once every seen tenant has nonzero service."""
        if len(self._tenant_seen) < 2:
            return
        vals = [self.tenant_service.get(t, 0) for t in self._tenant_seen]
        if all(vals):
            self.tick_stats["fairness_min_jain"] = min(
                self.tick_stats["fairness_min_jain"], jain_index(vals))

    def slo_report(self) -> dict:
        """Per-class attainment summary from the deterministic work-clock
        records: TTFT/TPOT percentiles, attainment fractions against the
        class targets, and terminal outcome counts."""
        out = {}
        for name in sorted(self.slo_classes):
            cls = self.slo_classes[name]
            log = self.class_log[name]
            n = log["completed"]
            row = {"completed": n, "expired": log["expired"],
                   "shed": log["shed"], "rejected": log["rejected"]}
            if log["ttft_work"]:
                row["ttft_work_p50"] = percentile(log["ttft_work"], 0.5)
                row["ttft_work_p95"] = percentile(log["ttft_work"], 0.95)
                if math.isfinite(cls.ttft_work_target):
                    row["ttft_attainment"] = sum(
                        1 for v in log["ttft_work"]
                        if v <= cls.ttft_work_target) / len(log["ttft_work"])
            if log["tpot_work"]:
                row["tpot_work_p95"] = percentile(log["tpot_work"], 0.95)
                if math.isfinite(cls.tpot_work_target):
                    row["tpot_attainment"] = sum(
                        1 for v in log["tpot_work"]
                        if v <= cls.tpot_work_target) / len(log["tpot_work"])
            terminal = n + log["expired"]
            if terminal:
                row["deadline_attainment"] = n / terminal
            out[name] = row
        return out

    # ----------------------------------------------------- island churn
    def drain_island(self, island_id: str, deregister: bool = False):
        """Begin graceful evacuation: the island stops taking new work at
        once (TIDE reports zero capacity, LIGHTHOUSE discovery excludes
        it) while each tick freezes up to ``migration_token_budget``
        context tokens of its in-flight requests and re-routes them
        through WAVES, so privacy, cost and latency constraints hold for
        the move as for the first placement. ``deregister=True`` removes
        the island from the registry once it is empty."""
        if island_id not in self.registry or island_id in self._draining:
            return
        self.registry.set_status(island_id, STATUS_DRAINING)
        self._draining[island_id] = deregister

    def fail_island(self, island_id: str):
        """Abrupt island loss: its batcher state (KV pages, slots, queue)
        is unrecoverable. Every stranded request requeues for re-routing
        from its prompt; under greedy decoding the rerun stream is the
        lost one, so a failure costs work, never correctness, and never
        loses or double-completes a request."""
        if island_id not in self.registry:
            return
        self.registry.set_status(island_id, STATUS_FAILED)
        self._draining.pop(island_id, None)
        self.batchers.pop(island_id, None)
        # a replacement batcher under the same id starts a fresh clock;
        # the mesh work clock already holds everything this one did
        self._work_seen.pop(island_id, None)
        self.waves.lighthouse.detach(island_id)
        n = 0
        for key in [k for k in self._local_inflight if k[0] == island_id]:
            p, _d = self._local_inflight.pop(key)
            p.ticket = None
            self.pending.append(p)
            self._otrace("failover", rid=p.rid, island=island_id)
            n += 1
        still = []
        for item in self._sim_inflight:
            _ready, p, d, _text, _exec_ms = item
            if d.island.island_id == island_id:
                p.ticket = None
                self.pending.append(p)
                self._otrace("failover", rid=p.rid, island=island_id)
                n += 1
            else:
                still.append(item)
        self._sim_inflight = still
        self.tick_stats["failovers"] += n

    def _on_island_deregistered(self, island_id: str):
        """Registry teardown hook: drop the island's batcher and counters;
        anything still in flight there fails over (a
        ``drain_island(deregister=True)`` arrives here already empty)."""
        self.batchers.pop(island_id, None)
        self._draining.pop(island_id, None)
        self._work_seen.pop(island_id, None)
        self._util_sum.pop(island_id, None)
        self._util_n.pop(island_id, None)
        for key in [k for k in self._local_inflight if k[0] == island_id]:
            p, _d = self._local_inflight.pop(key)
            p.ticket = None
            self.pending.append(p)
            self.tick_stats["failovers"] += 1

    def _return_to_source(self, p, t) -> bool:
        """Hand a frozen request back to its still-draining source to
        finish there (no destination would or could take it), with a
        capped exponential backoff before it may be frozen again (or until
        the routable island set changes)."""
        if t.source in self.batchers and p.decision is not None:
            p.ticket = None
            brid = self.batchers[t.source].submit_ticket(t)
            self._local_inflight[(t.source, brid)] = (p, p.decision)
            attempts = self._placement_backoff.get(p.rid, (0, 0))[0] + 1
            delay = min(BACKOFF_BASE_TICKS << (attempts - 1),
                        BACKOFF_CAP_TICKS)
            self._placement_backoff[p.rid] = (
                attempts, self.tick_stats["ticks"] + delay)
            self.tick_stats["migration_returns"] += 1
            self._otrace("migrate_return", rid=p.rid, island=t.source,
                         brid=brid, attempts=attempts,
                         backoff_ticks=delay)
            return True
        return False

    def _backed_off(self, rid: int) -> bool:
        ent = self._placement_backoff.get(rid)
        return ent is not None and self.tick_stats["ticks"] < ent[1]

    @staticmethod
    def _ticket_fits(b, t) -> bool:
        """Whether a destination batcher can hold the resumed context AND
        every still-owed decode token (WAVES routes on islands, not
        batcher geometry); the predicate the batcher's thaw applies."""
        pool = getattr(b, "pool", None)
        return ticket_fits(t, b.max_len,
                           page_size=getattr(b, "page_size", None),
                           num_pages=pool.num_pages
                           if pool is not None else None)

    @staticmethod
    def _import_allowed(island, tier) -> bool:
        """Raw KV (pages or a dense row) may only land on an island at
        least as trusted as the tier that produced it (island tier 1 =
        personal; KV tier 1 = most sensitive). Untiered KV never ships."""
        return tier is not None and island.tier <= tier

    def _service_draining(self):
        """One tick of drain progress: freeze in-flight requests off
        draining islands, and off TIDE-flagged stragglers (the hedge),
        budgeted by context tokens, and requeue them with their tickets so
        this tick's routing pass places them."""
        routable_fn = getattr(self.registry, "is_routable", None)
        routable = tuple(sorted(
            i.island_id for i in self.registry.all()
            if routable_fn is None or routable_fn(i.island_id)))
        if routable != self._last_routable:
            self._last_routable = routable
            self._placement_backoff.clear()  # mesh changed: retry now
        budget = self.migration_token_budget
        tide = self.waves.tide
        evacuating = list(self._draining) + [
            iid for iid in self.batchers
            if iid not in self._draining and tide.is_straggler(iid)]
        for iid in evacuating:
            hedging = iid not in self._draining
            b = self.batchers.get(iid)
            if b is None:
                continue
            for key in [k for k in self._local_inflight if k[0] == iid]:
                if budget <= 0:
                    break
                p, d = self._local_inflight[key]
                if self._backed_off(p.rid):
                    continue          # recently failed to place
                t = b.freeze_request(key[1])
                if t is None:
                    continue          # already finished: delivered below
                self._local_inflight.pop(key)
                t.source = iid
                p.ticket = t
                p.decision = d
                self.pending.append(p)
                # kv_tokens already counts generated tokens for decode
                # freezes; the max covers mid-prefill and queued tickets
                budget -= max(t.kv_tokens, len(t.generated), 1)
                self.tick_stats["migrations_started"] += 1
                if hedging:
                    self.tick_stats["hedges"] += 1
                self._otrace("migrate_out", rid=p.rid, island=iid,
                             brid=key[1], kv_tokens=t.kv_tokens,
                             phase=t.phase, hedge=hedging)

    def _finalize_drains(self):
        """End-of-tick drain completion (after deliveries, so the tick
        that finishes an island's last request also finishes its
        drain)."""
        for iid in list(self._draining):
            b = self.batchers.get(iid)
            empty = ((b is None or not b.busy())
                     and not any(k[0] == iid for k in self._local_inflight)
                     # tickets frozen off this island but not yet placed
                     # still need it as their return-to-source fallback
                     and not any(p.ticket is not None
                                 and p.ticket.source == iid
                                 for p in self.pending)
                     and not any(d.island.island_id == iid
                                 for _r, _p, d, _t, _e
                                 in self._sim_inflight))
            if empty:
                dereg = self._draining.pop(iid)
                self.tick_stats["islands_drained"] += 1
                if dereg:
                    self.registry.deregister(iid)

    # ----------------------------------------------- degradation ladder
    def _advance_mesh_work(self):
        """Fold each live batcher's work-clock advance into the monotonic
        mesh work clock (the per-island last-seen map makes it never go
        backwards across an island failure). SLO deadlines expire
        against it."""
        for iid, b in self.batchers.items():
            delta = b.work_clock - self._work_seen.get(iid, 0)
            if delta > 0:
                self.mesh_work += delta
            self._work_seen[iid] = b.work_clock

    def _expire(self, p, stage: str, island: str | None = None):
        """Terminal a request whose work-clock budget is spent: typed
        reject, TIDE expiry pressure on the island it died on, and the
        ``expire`` trace terminal."""
        self.rejected.append(Decision(None, False, RejectReason.EXPIRED,
                                      -1.0))
        self.results[p.rid] = None
        self._placement_backoff.pop(p.rid, None)
        self.tick_stats["expired"] += 1
        self._class_count(p.req, "expired")
        if island is not None:
            self.waves.tide.note_expiry(island)
        self._otrace("expire", rid=p.rid, stage=stage, island=island)

    def _expire_requests(self):
        """Expire every request whose deadline_work the mesh work clock
        has passed: queued, frozen mid-migration, in a batcher, or
        simulated. A request that FINISHED this tick (in ``b.finished``)
        is delivered normally: completion and expiry are exclusive."""
        now = self.mesh_work
        keep = []
        for p in self.pending:
            if p.deadline_work <= now and p.rid not in self.results:
                self._expire(p, "frozen" if p.ticket is not None
                             else "queued",
                             island=(p.ticket.source
                                     if p.ticket is not None else None))
            else:
                keep.append(p)
        self.pending = keep
        for key in [k for k, (p, _d) in self._local_inflight.items()
                    if p.deadline_work <= now]:
            iid, brid = key
            b = self.batchers.get(iid)
            if b is not None and brid in b.finished:
                continue          # completed this tick: deliver, not expire
            p, _d = self._local_inflight.pop(key)
            if b is not None:
                b.cancel_request(brid)
            self._expire(p, "inflight", island=iid)
        still = []
        for item in self._sim_inflight:
            _ready, p, d, _text, _exec_ms = item
            if p.deadline_work <= now:
                self._expire(p, "sim", island=d.island.island_id)
            else:
                still.append(item)
        self._sim_inflight = still

    def _shed_overload(self):
        """Watermark-driven load shedding: saturation is the worst ratio
        of (pending pool, mesh prefill backlog, max pool occupancy) to
        its watermark. The level is published to the Lighthouse every
        tick (hardened for tenant viewers: the backpressure hint); at or
        above 1.0 the newest lowest-priority sheddable pending requests
        are dropped with the typed ``shed`` reason until the pool is back
        at the queue watermark."""
        pol = self.overload
        if not pol.enabled():
            return
        sat = 0.0
        if pol.queue_watermark:
            sat = max(sat, len(self.pending) / pol.queue_watermark)
        if pol.backlog_watermark:
            sat = max(sat, self.waves.lighthouse.mesh_prefill_backlog()
                      / pol.backlog_watermark)
        if pol.occupancy_watermark:
            occs = [b.pool.occupancy() for b in self.batchers.values()
                    if getattr(b, "pool", None) is not None]
            if occs:
                sat = max(sat, max(occs) / pol.occupancy_watermark)
        self.waves.lighthouse.report_saturation(min(sat, 1.0))
        if sat < 1.0:
            return
        target = pol.queue_watermark or 0
        sheddable = sorted(
            (p for p in self.pending
             if p.ticket is None
             and pol.shed_rank(p.req.priority) < len(pol.shed_priorities)),
            key=lambda p: (pol.shed_rank(p.req.priority), -p.rid))
        drop = set()
        for p in sheddable:
            if len(self.pending) - len(drop) <= target:
                break
            drop.add(p.rid)
            self.rejected.append(Decision(None, False, RejectReason.SHED,
                                          -1.0))
            self.results[p.rid] = None
            self.tick_stats["shed"] += 1
            self._class_count(p.req, "shed")
            self._otrace("reject", rid=p.rid,
                         reason=str(RejectReason.SHED))
        if drop:
            self.pending = [p for p in self.pending if p.rid not in drop]

    # ------------------------------------------------------------ routing
    def route_pool(self, reqs: list) -> list:
        """Route a list of Requests exactly as one scheduling tick would
        (used directly by the parity tests); returns one Decision per
        request, in order."""
        pool = [PendingRequest(-1 - i, r, 0, self.waves.tide.clock)
                for i, r in enumerate(reqs)]
        return self._route_pool(pool)

    def _route_pool(self, pool) -> list:
        waves = self.waves
        pol = waves.policy
        if waves._extra_agents:
            # extension agents are opaque Python callables — keep their
            # semantics by delegating the whole pool to the scalar oracle
            return [waves.route(p.req) for p in pool]
        decisions: list = [None] * len(pool)
        live = []                        # (pool index, sensitivity)
        for idx, p in enumerate(pool):
            if not waves._limiter.allow(p.req.user, waves.tide.clock):
                decisions[idx] = Decision(None, False, "rate_limited", -1.0)
                continue
            s_r = (p.req.sensitivity_override
                   if p.req.sensitivity_override is not None
                   else waves.mist.analyze(p.req.query).score)
            live.append((idx, s_r))
        islands = waves.lighthouse.get_islands()
        # a crashed LIGHTHOUSE serves its cached list unfiltered; drop
        # draining/failed islands here so the batched router can never
        # route onto them (the scalar path rejects them via TIDE.admits)
        routable = getattr(self.registry, "is_routable", None)
        if routable is not None:
            islands = [i for i in islands if routable(i.island_id)]
        # TIDE-flagged stragglers take no new work while flagged; if EVERY
        # island is flagged, keep them all
        ok = [i for i in islands
              if not waves.tide.is_straggler(i.island_id)]
        if ok:
            islands = ok
        if not live:
            return decisions
        if not islands:
            for idx, s_r in live:
                decisions[idx] = Decision(None, False, "infeasible", s_r)
            return decisions

        dev = self.device
        ds_ids = sorted({pool[idx].req.dataset for idx, _ in live
                         if pool[idx].req.dataset})
        # pad the dataset columns to a power of two with names no island
        # declares (all-False columns), as the reference does
        if ds_ids:
            ds_cols = 1 << (len(ds_ids) - 1).bit_length()
            ds_ids_padded = ds_ids + [f"__pad{i}"
                                      for i in range(ds_cols - len(ds_ids))]
        else:
            ds_ids_padded = []
        tbl = rt.pack_islands(islands, ds_ids_padded, waves.tide,
                              pol.trust_mode, device=dev)
        # bucket the pool to the next power of two, as the reference does.
        # Padding rows carry sensitivity 2.0: infeasible on every island
        # (privacy <= 1), never queued, so they add no load and touch no
        # hysteresis
        m = len(live)
        M = 1 << (m - 1).bit_length()
        pad = M - m
        reqs = rt.pack_requests(
            [s for _, s in live] + [2.0] * pad,
            [waves.tide.threshold(pool[idx].req.priority)
             for idx, _ in live] + [0.0] * pad,
            [pool[idx].req.deadline_ms for idx, _ in live]
            + [math.inf] * pad,
            [ds_ids.index(pool[idx].req.dataset)
             if pool[idx].req.dataset else -1 for idx, _ in live]
            + [-1] * pad,
            [pool[idx].req.priority == "primary" for idx, _ in live]
            + [False] * pad,
            n_datasets=max(len(ds_ids), 1), device=dev)
        # request×island constraints outside the packed tables
        extra = np.ones((M, len(islands)), bool)
        for row, (idx, _) in enumerate(live):
            r = pool[idx].req
            for col, isl in enumerate(islands):
                if r.model and isl.models and r.model not in isl.models:
                    extra[row, col] = False
                if pol.allowed_jurisdictions is not None and \
                        isl.jurisdiction not in pol.allowed_jurisdictions:
                    extra[row, col] = False
        state = rt.pack_tide_state(islands, waves.tide, device=dev)
        budget = (pol.budget_per_request
                  if pol.budget_per_request is not None else math.inf)
        weights = torch.tensor([pol.w_cost, pol.w_latency, pol.w_privacy],
                               dtype=torch.float32, device=dev)
        assign, acc, que, score, ncand, new_state = rt.route_batch_tick(
            tbl, reqs, weights, state, torch.from_numpy(extra).to(dev),
            mode=pol.mode, on_infeasible=pol.on_infeasible, budget=budget,
            min_trust=pol.min_trust, cost_scale=pol.cost_scale,
            latency_scale=pol.latency_scale_ms)
        # ONE device -> host transfer for the whole tick's results; every
        # value is exact in float32 (small ints, bools, float32 state)
        keys = ("cpu", "gpu", "mem", "inflight", "local_ok")
        host = torch.cat([assign.float(), acc.float(), que.float(), score,
                          ncand.float()]
                         + [new_state[k].float() for k in keys]).cpu().numpy()
        n = len(islands)
        assign, acc, que, score, ncand = (host[k * M:(k + 1) * M]
                                          for k in range(5))
        fin = {k: host[5 * M + c * n:5 * M + (c + 1) * n]
               for c, k in enumerate(keys)}
        fin["local_ok"] = fin["local_ok"] > 0.5
        rt.unpack_tide_state(fin, islands, waves.tide)
        for row, (idx, s_r) in enumerate(live):
            if not acc[row]:
                decisions[idx] = Decision(None, False, "infeasible", s_r)
                continue
            island = islands[int(assign[row])]
            reason = "queued_local" if que[row] else "routed"
            # queued_local: the scalar path reports the _finish default
            # (1), not the zero feasible islands the router counted
            d = waves._finish(pool[idx].req, island, s_r, reason,
                              n_candidates=1 if que[row]
                              else int(ncand[row]),
                              account_load=False)
            d.score = float(score[row])
            decisions[idx] = d
        self.tick_stats["route_calls"] += 1
        return decisions

    # --------------------------------------------------------------- tick
    def tick(self) -> list:
        """One scheduling tick; returns the Responses completed in it."""
        waves = self.waves
        completed: list[Response] = []
        self._advance_mesh_work()
        self._service_draining()
        # degradation ladder, in order: expire blown SLO budgets, then
        # shed overload, then route what remains
        self._expire_requests()
        self._shed_overload()
        pool, self.pending = self.pending, []
        if self.fair_tenancy and len(pool) > 1:
            self._fair_order(pool)
        if pool:
            if self.tracer is not None:
                # per-island capacity snapshot for this routing pass
                # (peek_capacity does not advance TIDE's EWMA state)
                self._otrace("route_tick", pool=len(pool), capacities={
                    i.island_id: round(
                        waves.tide.peek_capacity(i.island_id), 4)
                    for i in self.registry.all()})
            for p, d in zip(pool, self._route_pool(pool)):
                if not d.accepted:
                    # nowhere to migrate: the draining source keeps it and
                    # finishes it under its original decision
                    if p.ticket is not None \
                            and self._return_to_source(p, p.ticket):
                        continue
                    self.rejected.append(d)
                    self.results[p.rid] = None
                    self._placement_backoff.pop(p.rid, None)
                    self._class_count(p.req, "rejected")
                    self._otrace("reject", rid=p.rid, reason=d.reason)
                    continue
                self.tick_stats["routed"] += 1
                self._placement_backoff.pop(p.rid, None)
                island = d.island
                self._otrace("route", rid=p.rid,
                             island=island.island_id,
                             score=(round(d.score, 4)
                                    if d.score is not None else None),
                             reason=d.reason,
                             n_candidates=d.n_candidates)
                query = (d.sanitized_history[-1] if d.sanitize
                         else p.req.query)
                b = self.batchers.get(island.island_id)
                tkt, p.ticket = p.ticket, None
                if tkt is not None and tkt.prompt != query:
                    # the new island sanitizes differently: nothing
                    # computed for the old text is reusable (fail closed)
                    self.tick_stats["restarts"] += 1
                    self._otrace("restart", rid=p.rid,
                                 reason="sanitize_mismatch")
                    tkt = None
                if b is not None:
                    if tkt is not None and not self._ticket_fits(b, tkt):
                        # a batcher too small for the resumed context:
                        # prefer finishing at the source, else restart here
                        # from the prompt alone
                        if self._return_to_source(p, tkt):
                            continue
                        self.tick_stats["restarts"] += 1
                        self._otrace("restart", rid=p.rid,
                                     reason="ticket_too_large")
                        tkt = None
                    if tkt is not None:
                        if (tkt.pages or tkt.dense is not None) and \
                                not self._import_allowed(island, tkt.tier):
                            # the destination may not receive raw KV (page
                            # records OR a dense row): keep the progress,
                            # recompute the context
                            tkt = tkt.without_pages()
                        brid = b.submit_ticket(tkt)
                        self._otrace("migrate_in", rid=p.rid,
                                     island=island.island_id, brid=brid,
                                     source=tkt.source,
                                     with_pages=bool(tkt.pages
                                                     or tkt.dense
                                                     is not None))
                        # thawing a context is real work for the
                        # destination: charge it so later migrations
                        # spread instead of dogpiling
                        waves.tide.add_load(
                            island.island_id,
                            len(tkt.context_ids())
                            / MIGRATION_TOKENS_PER_UNIT)
                    else:
                        # KV pages this request produces carry its MIST
                        # trust tier; prefix sharing is only legal within
                        # a tier
                        brid = b.submit(
                            query, p.max_new_tokens,
                            trust_tier=trust_tier_for_sensitivity(
                                d.sensitivity),
                            slo_rank=self._slo_rank(p.req))
                        self._otrace("dispatch", rid=p.rid,
                                     island=island.island_id, brid=brid)
                    self._local_inflight[(island.island_id, brid)] = (p, d)
                else:
                    # simulated executor: a cross-executor move cannot
                    # preserve a KV stream, so a migrated request restarts
                    if tkt is not None:
                        self.tick_stats["restarts"] += 1
                        self._otrace("restart", rid=p.rid,
                                     reason="cross_executor")
                    text, exec_ms = self.cloud.complete(island, query)
                    ready = waves.tide.clock + \
                        (island.latency_ms + exec_ms) / 1000.0
                    self._sim_inflight.append((ready, p, d, text, exec_ms))
                    self._otrace("dispatch_sim", rid=p.rid,
                                 island=island.island_id,
                                 exec_ms=round(exec_ms, 3))
        # SHORE: continuous-batching ticks
        for iid, b in self.batchers.items():
            blocked = 0            # accumulated: b.tick() resets its count
            for _ in range(self.decode_ticks_per_tick):
                if not b.busy():
                    break
                b.tick()
                blocked += getattr(b, "blocked_last_tick", 0)
                self.tick_stats["decode_ticks"] += 1
                self._util_sum[iid] = self._util_sum.get(iid, 0.0) \
                    + b.utilization()
                self._util_n[iid] = self._util_n.get(iid, 0) + 1
            for brid in list(b.finished):
                key = (iid, brid)
                if key not in self._local_inflight:
                    continue           # submitted outside the orchestrator
                p, d = self._local_inflight.pop(key)
                text = b.finished.pop(brid)
                if text is None:       # executor-level rejection (e.g. the
                    self.rejected.append(d)    # request can't fit the pool)
                    self.results[p.rid] = None
                    self._class_count(p.req, "rejected")
                    self._otrace("reject", rid=p.rid, island=iid,
                                 reason="executor")
                    continue
                completed.append(self._complete(
                    p, d, text, rec=b.request_log.get(brid)))
            # KV-pool pressure feedback + telemetry (paged batchers only)
            kv_pool = getattr(b, "pool", None)
            if kv_pool is not None:
                if waves.tide.crashed:
                    # fail closed: no prefix sharing on a crashed-TIDE
                    # island
                    kv_pool.disable_sharing()
                backlog = b.prefill_backlog_tokens()
                waves.tide.report_pool_pressure(
                    iid, kv_pool.occupancy(), blocked=blocked,
                    prefill_backlog=backlog)
                waves.lighthouse.report_pool(iid, dict(
                    kv_pool.telemetry(), prefill_backlog=backlog,
                    prefix_tokens_skipped=b.stats.get(
                        "prefix_tokens_skipped", 0),
                    work_clock=b.work_clock, tiers=b.tier_telemetry()))
            if any(b.migration_stats.values()):
                waves.lighthouse.report_migration(iid, b.migration_stats)
        # per-island progress feedback for straggler detection (the delta
        # against the last-seen clock BEFORE _advance_mesh_work folds it
        # into the mesh clock below)
        for iid, b in self.batchers.items():
            waves.tide.report_progress(
                iid, b.work_clock - self._work_seen.get(iid, 0), b.busy())
        # per-class SLO lag joins progress in the routing feedback loop
        # (slo_aware only: the accounting-only arm must not steer)
        if self.slo_aware and self.slo_classes:
            self._report_slo_pressure()
        self._advance_mesh_work()
        bs = self.batchers.values()
        for k in ("admissions", "prefill_dispatches", "device_dispatches"):
            self.tick_stats[k] = sum(b.stats.get(k, 0) for b in bs)
        self.tick_stats["tick_dispatches_max"] = max(
            [b.stats.get("tick_dispatches_max", 0) for b in bs] or [0])
        # migration outcome totals (live batchers only: a failed island's
        # counters died with it)
        for k, src in (("migrations", "imports"), ("recomputes",
                       "recomputes"), ("pages_shipped", "imported_pages")):
            self.tick_stats[k] = sum(b.migration_stats.get(src, 0)
                                     for b in bs)
        # advance virtual time
        waves.tide.advance(self.tick_interval_s)
        waves.lighthouse.advance(self.tick_interval_s)
        for isl in self.registry.all():
            if self.registry.status(isl.island_id) != STATUS_FAILED:
                waves.lighthouse.heartbeat(isl.island_id)
        # HORIZON / simulated completions whose latency has elapsed
        still = []
        for ready, p, d, text, exec_ms in self._sim_inflight:
            if ready <= waves.tide.clock:
                # elapsed virtual time already contains the island's base
                # latency (it set the ready time) — don't add it again
                completed.append(self._complete(p, d, text, exec_ms,
                                                include_base=False))
            else:
                still.append((ready, p, d, text, exec_ms))
        self._sim_inflight = still
        self._finalize_drains()
        if self.debug_audit:
            # end-of-tick page-pool invariant check: a refcount-vs-table
            # violation surfaces at the tick that caused it
            for iid, b in self.batchers.items():
                kv_pool = getattr(b, "pool", None)
                if kv_pool is not None:
                    try:
                        kv_pool.audit()
                    except AssertionError as e:
                        raise AssertionError(
                            f"PagePool audit failed on {iid} at tick "
                            f"{self.tick_stats['ticks']}: {e}") from e
        self._snapshot_fairness()
        self.tick_stats["ticks"] += 1
        return completed

    def _complete(self, p, d, text, exec_ms=0.0,
                  include_base=True, rec=None) -> Response:
        self._account_completion(p.req, rec)
        if d.sanitize and d.placeholder_store is not None:
            text = self.waves.mist.desanitize(text, d.placeholder_store)
        elapsed = (self.waves.tide.clock - p.submitted_at) * 1000.0
        latency = max(elapsed, exec_ms)
        if include_base:                 # local exec: add the network RTT
            latency += d.island.latency_ms
        resp = Response(text=text, island_id=d.island.island_id,
                        latency_ms=latency,
                        cost=d.island.cost_per_request,
                        sensitivity=d.sensitivity, sanitized=d.sanitize,
                        decision=d, island_privacy=d.island.privacy)
        self.log.append(resp)
        self.results[p.rid] = resp
        self._otrace("complete", rid=p.rid, island=d.island.island_id,
                     latency_ms=round(latency, 3))
        return resp

    # ------------------------------------------------------------ control
    def busy(self) -> bool:
        return bool(self.pending or self._local_inflight
                    or self._sim_inflight)

    def run_until_done(self, max_ticks=10_000) -> list:
        """Tick until every submitted request has resolved; returns the
        Responses completed during the run."""
        out = []
        while self.busy() and self.tick_stats["ticks"] < max_ticks:
            out.extend(self.tick())
        return out

    # ----------------------------------------------------------- metrics
    def stats(self):
        s = aggregate_stats(self.log, self.rejected, self.registry)
        s.update(self.tick_stats)
        s["utilization"] = {iid: self._util_sum.get(iid, 0.0)
                            / max(self._util_n.get(iid, 0), 1)
                            for iid in self.batchers}
        pools = self.waves.lighthouse.pool_telemetry()
        if pools:
            s["kv_pools"] = pools
            s["prefill_backlog"] = \
                self.waves.lighthouse.mesh_prefill_backlog()
        if self.waves.lighthouse.migration_telemetry():
            s["migration"] = self.waves.lighthouse.mesh_migration_stats()
        s["island_status"] = {i.island_id: self.registry.status(i.island_id)
                              for i in self.registry.all()}
        if self.slo_classes:
            s["slo"] = self.slo_report()
        if self.tenant_service:
            s["tenant_service"] = dict(sorted(self.tenant_service.items()))
        return s


def build_island_batchers(cfg, registry, cache="auto", params=None,
                          slots_per_capacity_unit=2.0, max_len=96,
                          page_size=16, pool_headroom=1.0, seed=0,
                          temperature=0.0, prefill="chunked",
                          prefill_token_budget=None, fused=True,
                          constant_shape=False, tier_quotas=None,
                          class_aware=False, device=None):
    """Per-SHORE-island continuous batchers (``cache`` "auto", "stacked"
    or "paged") with KV pools sized from each island's declared
    ``capacity_units``.

    Slot count scales linearly with capacity; in paged mode the page pool
    is sized to ``slots * pages_per_seq * pool_headroom`` — headroom 1.0
    can hold every slot fully private (never stalls), < 1.0 deliberately
    oversubscribes so the pool only fits the workload when prefix sharing
    pays, and otherwise preempts. Model parameters are initialized once
    (on ``device``, None = the card) and shared across islands.
    ``class_aware`` batchers schedule by SLO rank; ``constant_shape`` and
    ``tier_quotas`` are not ported yet and raise."""
    from repro_torch.serving.batcher import (make_batcher, paged_supported,
                                             refuse_unported)
    refuse_unported(constant_shape, tier_quotas)
    if cache == "auto":                 # resolve once so sizing matches
        cache = "paged" if paged_supported(cfg) else "stacked"
    pages_per_seq = -(-max_len // page_size)
    out = {}
    for isl in registry.all():
        if isl.endpoint != "shore":
            continue
        slots = max(1, int(round(slots_per_capacity_unit
                                 * isl.capacity_units)))
        # page kwargs are computed unconditionally; make_batcher drops
        # them for the stacked manager
        b = make_batcher(
            cfg, cache=cache, params=params, num_slots=slots,
            max_len=max_len, seed=seed, temperature=temperature,
            page_size=page_size, prefill=prefill,
            prefill_token_budget=prefill_token_budget, fused=fused,
            class_aware=class_aware,
            num_pages=max(2, int(slots * pages_per_seq
                                 * pool_headroom)) + 1,
            device=device)
        if params is None:
            params = b.params        # share weights across islands
        out[isl.island_id] = b
    return out
