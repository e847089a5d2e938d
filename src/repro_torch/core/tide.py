"""TIDE — Temporal Island Demand Evaluator (paper Sec IX).

Monitors per-island utilization and computes available capacity

    R(t) = 1 - max(cpu, gpu, mem)                       (Eq. 3)

with user-configurable buffers (conservative 30% / moderate 20% /
aggressive 10%), hysteresis-based fallback (out below 70%, back above 80%)
to prevent route flapping, EWMA-based exhaustion prediction, and the
priority-tier gates (primary always-local, secondary R>50%, burstable
R>80%).

Real phones/NAS/cloud don't exist in this container, so utilization is a
simulated process: requests add load proportional to their work estimate
and decay over a virtual clock. A crashed TIDE fails conservative:
R_local = 0 (resources exhausted).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.islands import STATUS_ACTIVE

# Paper Sec IX-A, implemented literally: with buffer b, route to cloud when
# local capacity R < 1-b (conservative 30% -> R<0.70, moderate 20% -> R<0.80,
# aggressive 10% -> R<0.90).
BUFFERS = {"conservative": 0.30, "moderate": 0.20, "aggressive": 0.10}

# Sec IX-C hysteresis: fall back below the buffer threshold, recover only
# DEAD_ZONE above it (paper's 70%/80% pair = conservative buffer + 10%).
DEAD_ZONE = 0.10

# Sec IX-B priority-tier gates: secondary local if R>50%, burstable if R>80%
TIER_GATES = {"primary": 0.0, "secondary": 0.50, "burstable": 0.80}

# One work unit's resource mix (add_load), the queueing-delay inflation
# factor (effective_latency_ms) and the hysteresis recovery clamp (admits).
# Named so the batched routing kernel (core.routing_jax.route_batch_tick)
# imports the SAME constants and cannot drift from the scalar semantics.
LOAD_MIX = {"gpu": 0.8, "cpu": 0.3, "mem": 0.2}
QUEUE_FACTOR = 2.0
RECOVERY_CAP = 0.99

# One queued work unit's worth of undispatched prefill-chunk tokens: a
# serving island's prefill backlog (chunked admission queue) converts to
# inflight work at this rate before feeding the queueing-latency term.
PREFILL_BACKLOG_TOKENS_PER_UNIT = 64.0

# One work unit's worth of migrated context tokens: thawing a migrated
# request onto an island costs page imports or a recompute prefill, so the
# engine charges the destination at this rate — drain pressure spreads a
# drained island's load across destinations instead of dogpiling the first.
MIGRATION_TOKENS_PER_UNIT = 128.0

# Inflight work units one SLO expiry charges the island it died on
# (note_expiry): expiring requests mean the island is not keeping up, so
# routing's queueing-latency term steers new work away until the charge
# decays — saturated islands stop attracting the work they cannot finish.
EXPIRY_PENALTY_UNITS = 1.0

# One queued work unit's worth of SLO lag: work-clock units by which an
# island's resident requests have overshot their class TTFT/TPOT targets
# (report_slo_lag). A softer signal than note_expiry — it fires while the
# SLO is merely *at risk* rather than blown, so class-aware routing sheds
# load off a lagging island before deadlines start expiring on it.
SLO_LAG_TOKENS_PER_UNIT = 96.0


@dataclass
class LoadState:
    cpu: float = 0.05
    gpu: float = 0.0
    mem: float = 0.10
    inflight: float = 0.0          # active work units
    ewma_r: float = 1.0
    ewma_slope: float = 0.0
    local_ok: bool = True          # hysteresis state
    last_t: float = 0.0


class TIDE:
    def __init__(self, registry, buffer: str = "moderate",
                 crashed: bool = False, decay_s: float = 2.0,
                 monitor_interval_s: float = 1.0,
                 straggler_patience: int | None = None):
        self.registry = registry
        self.buffer = buffer
        self.crashed = crashed
        self.decay_s = decay_s
        self.monitor_interval_s = monitor_interval_s  # paper: 1s sampling
        self.state: dict[str, LoadState] = {}
        self.clock: float = 0.0
        # straggler detection (opt-in): consecutive busy-but-zero-work
        # ticks raise an island's slow score, progress pays it down;
        # score >= patience flags the island (no admission, hedged by
        # the engine), score back to 0 unflags it. None disables —
        # report_progress becomes a no-op, nothing is ever flagged.
        self.straggler_patience = straggler_patience
        self._slow_score: dict[str, int] = {}
        self._stragglers: set = set()
        hook = getattr(registry, "add_teardown_hook", None)
        if hook is not None:
            hook(self.detach)

    # ------------------------------------------------------------ process
    def _st(self, island_id: str) -> LoadState:
        return self.state.setdefault(island_id, LoadState())

    def detach(self, island_id: str):
        """Drop per-island load state (registry teardown hook): a
        deregistered island must not keep decaying phantom load or stale
        hysteresis that would resurface if the id is ever reused."""
        self.state.pop(island_id, None)
        self._slow_score.pop(island_id, None)
        self._stragglers.discard(island_id)

    def advance(self, dt: float):
        """Advance the virtual clock; load decays exponentially."""
        self.clock += dt
        k = math.exp(-dt / self.decay_s)
        for st in self.state.values():
            st.cpu = 0.05 + (st.cpu - 0.05) * k
            st.gpu *= k
            st.mem = 0.10 + (st.mem - 0.10) * k
            st.inflight *= k

    def add_load(self, island_id: str, work: float):
        """Account a request's work on an island (bounded islands only)."""
        island = self.registry.get(island_id)
        if island.unbounded:
            return
        st = self._st(island_id)
        w = work / max(island.capacity_units, 1e-6)
        st.gpu = min(1.0, st.gpu + LOAD_MIX["gpu"] * w)
        st.cpu = min(1.0, st.cpu + LOAD_MIX["cpu"] * w)
        st.mem = min(1.0, st.mem + LOAD_MIX["mem"] * w)
        st.inflight += w

    # ----------------------------------------------------------- capacity
    def capacity(self, island_id: str) -> float:
        """R(t) = 1 - max(cpu, gpu, mem).  Crashed TIDE -> 0 (conservative).
        Draining/failed islands report 0 available capacity — the drain
        pressure that keeps them out of the routing objective even when a
        crashed LIGHTHOUSE serves a stale cached island list."""
        if self.crashed:
            return 0.0
        if not self._active(island_id) or island_id in self._stragglers:
            return 0.0
        island = self.registry.get(island_id)
        if island.unbounded:
            return 1.0  # HORIZON: infinite capacity
        st = self._st(island_id)
        r = 1.0 - max(st.cpu, st.gpu, st.mem)
        # EWMA + slope for exhaustion prediction
        a = 0.3
        prev = st.ewma_r
        st.ewma_r = (1 - a) * st.ewma_r + a * r
        st.ewma_slope = (1 - a) * st.ewma_slope + a * (st.ewma_r - prev)
        return r

    def peek_capacity(self, island_id: str) -> float:
        """``capacity`` WITHOUT the EWMA update — a pure read for
        observers (the span tracer's per-tick capacity snapshot).
        ``capacity`` itself mutates exhaustion-prediction state, so an
        observer calling it would perturb routing; this never may."""
        if self.crashed or not self._active(island_id) \
                or island_id in self._stragglers:
            return 0.0
        island = self.registry.get(island_id)
        if island.unbounded:
            return 1.0
        st = self.state.get(island_id)
        if st is None:
            return 1.0 - max(0.05, 0.0, 0.10)   # LoadState() baseline
        return 1.0 - max(st.cpu, st.gpu, st.mem)

    def threshold(self, priority: str = "secondary") -> float:
        """Minimum capacity to accept a request locally. The Sec IX-B tier
        gates (primary 0 / secondary 0.50 / burstable 0.80) are the floors at
        the default *moderate* buffer; the buffer knob shifts them:
        conservative relaxes by 0.10 (keep more work local), aggressive
        tightens by 0.10 (protect responsiveness), exactly reproducing the
        paper's 70/80/90 ladder for the burstable tier."""
        if priority == "primary":
            return 0.0
        gate = TIER_GATES.get(priority, TIER_GATES["secondary"])
        shift = (1.0 - BUFFERS[self.buffer]) - 0.80
        return float(min(max(gate + shift, 0.0), 0.95))

    def _active(self, island_id: str) -> bool:
        status = getattr(self.registry, "status", None)
        return status is None or status(island_id) == STATUS_ACTIVE

    # --------------------------------------------------- straggler flag
    def report_progress(self, island_id: str, work_delta: int,
                        busy: bool):
        """Per-tick progress feedback from the engine: ``work_delta`` is
        the island's work-clock advance this tick, ``busy`` whether it
        held any work. A busy tick with zero progress raises the slow
        score; any other tick pays one unit down — so an island slowed
        to 1/k speed accrues ~(k-2)/k score per tick and flags, while a
        healthy island (or one given an idle breather) drains back to
        zero and unflags. Deterministic, and a no-op unless
        ``straggler_patience`` is set."""
        if self.straggler_patience is None:
            return
        score = self._slow_score.get(island_id, 0)
        if busy and work_delta <= 0:
            score += 1
        else:
            score = max(0, score - 1)
        self._slow_score[island_id] = score
        if score >= self.straggler_patience:
            self._stragglers.add(island_id)
        elif score == 0:
            self._stragglers.discard(island_id)

    def is_straggler(self, island_id: str) -> bool:
        return island_id in self._stragglers

    def note_expiry(self, island_id: str):
        """SLO-expiry pressure feedback: charge the island a request
        expired on ``EXPIRY_PENALTY_UNITS`` of queued work, inflating
        its queueing-latency term so routing stops feeding an island
        that is blowing deadlines. Decays with the virtual clock like
        every other load signal."""
        if island_id not in self.registry:
            return
        island = self.registry.get(island_id)
        if island.unbounded:
            return
        st = self._st(island_id)
        st.inflight += EXPIRY_PENALTY_UNITS \
            / max(island.capacity_units, 1e-6)

    def report_slo_lag(self, island_id: str, lag_tokens: float):
        """Per-class SLO pressure feedback from the engine: ``lag_tokens``
        is the summed work-clock overshoot of the island's resident
        requests against their class TTFT/TPOT targets this tick. It
        converts to queued inflight work at ``SLO_LAG_TOKENS_PER_UNIT``,
        inflating the queueing-latency term the routing kernel scores —
        the latency/queueing objective becomes SLO-aware without touching
        the score formula. Decays with the virtual clock like every other
        load signal."""
        if lag_tokens <= 0.0 or island_id not in self.registry:
            return
        island = self.registry.get(island_id)
        if island.unbounded:
            return
        st = self._st(island_id)
        queued = lag_tokens / SLO_LAG_TOKENS_PER_UNIT
        st.inflight = max(st.inflight,
                          queued / max(island.capacity_units, 1e-6))

    def admits(self, island_id: str, priority: str = "secondary") -> bool:
        if not self._active(island_id):
            return False         # draining/failed: no new work, any priority
        if island_id in self._stragglers:
            return False         # flagged straggler: hedge, don't feed
        island = self.registry.get(island_id)
        if island.unbounded:
            return True
        if priority == "primary":
            return True  # primary may queue locally, never bounced
        r = self.capacity(island_id)
        st = self._st(island_id)
        req = self.threshold(priority)
        if st.local_ok:
            if r < req:          # fall back
                st.local_ok = False
                return False
            return True
        # fallen back: require the recovery threshold (dead zone) to return
        if r >= min(req + DEAD_ZONE, RECOVERY_CAP):
            st.local_ok = True
            return True
        return False

    def report_pool_pressure(self, island_id: str, occupancy: float,
                             blocked: int = 0, prefill_backlog: int = 0):
        """KV page-pool pressure feedback from a SHORE island's serving
        stack (serving.kvpool): pool occupancy raises the island's ``mem``
        utilization — cutting capacity R = 1 - max(cpu, gpu, mem) and with
        it admission — while admissions blocked on page exhaustion and the
        island's prefill backlog (``prefill_backlog`` prompt tokens
        admitted/queued but not yet prefilled under the chunked-admission
        budget) count as queued inflight work, inflating the queueing-
        latency term the routing kernel scores (route_batch_tick packs
        ``inflight`` via pack_tide_state) — so the batched router steers
        new work away from prefill-saturated islands. All signals decay
        with the virtual clock like any other load."""
        island = self.registry.get(island_id)
        if island.unbounded:
            return
        st = self._st(island_id)
        st.mem = min(1.0, max(st.mem, float(occupancy)))
        queued = blocked + prefill_backlog / PREFILL_BACKLOG_TOKENS_PER_UNIT
        if queued:
            st.inflight = max(st.inflight,
                              queued / max(island.capacity_units, 1e-6))

    def effective_latency_ms(self, island) -> float:
        """Queueing-aware latency: base RTT+inference inflated by inflight
        work on bounded islands. This is what makes the paper's
        'latency-greedy routes to cloud' failure mode reproducible: a loaded
        laptop stops being the fastest endpoint."""
        if island.unbounded or self.crashed:
            return island.latency_ms
        st = self._st(island.island_id)
        return island.latency_ms * (1.0 + QUEUE_FACTOR * st.inflight)

    def predict_exhaustion_s(self, island_id: str):
        """Seconds until R hits 0 at the current EWMA slope (None if
        capacity is stable or growing)."""
        st = self._st(island_id)
        if st.ewma_slope >= -1e-6:
            return None
        return max(0.0, st.ewma_r / -st.ewma_slope) * self.monitor_interval_s
