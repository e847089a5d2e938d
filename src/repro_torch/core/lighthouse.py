"""LIGHTHOUSE — mesh topology + island liveness (paper Sec IV, X).

Maintains heartbeats over a virtual clock, island discovery (devices
announce availability when coming online) and the conservative fallback:
if LIGHTHOUSE itself crashes, WAVES keeps routing against the last cached
island list (correct but slower to react, per the ablation in Sec XI-D).

Telemetry published here is an observable side channel: raw per-island
pool counters let a co-tenant correlate page/hit deltas with another
tenant's requests (the access-pattern leak class the privacy harness in
``repro.privacy`` attacks). The mesh therefore serves TWO views:

* the **raw view** (``pool_telemetry()`` / ``mesh_prefill_backlog()``
  with no viewer tier) — per-island, unperturbed, orchestrator/operator
  only;
* the **tier-scoped view** (same calls with ``viewer_tier=t``) — a single
  mesh-wide aggregate over trust tiers the viewer may see (its own tier
  and less-sensitive ones, i.e. tier' >= t), quantized and perturbed with
  deterministic value-keyed noise, with no per-island resolution and no
  work-clock counters (cumulative work deltas re-expose per-request
  timing even when aggregated).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field


@dataclass(frozen=True)
class TelemetryPolicy:
    """How pool telemetry is hardened before crossing a trust boundary.

    ``tier_scoped`` gates the aggregation itself (off = positive-control
    ablation: scoped calls degrade to the raw mesh view). ``noise`` adds
    deterministic value-keyed perturbation on top of quantization: the
    reported value is a pure function of (seed, metric, viewer tier, true
    quantized value), so repeated observation of the same state can't be
    averaged away, yet CI gates stay bit-deterministic.
    """
    tier_scoped: bool = True
    noise: bool = True
    quantum_pages: int = 4
    quantum_tokens: int = 64
    # granularity of the mesh-saturation hint (percent): coarse enough
    # that the backpressure signal cannot fingerprint another tenant's
    # load, fine enough for WAVES to back off before submit
    quantum_saturation_pct: int = 25
    seed: int = 0


def harden_value(policy: TelemetryPolicy, metric: str, value: int,
                 quantum: int, viewer_tier: int) -> int:
    """Harden one scalar for a scoped viewer: round UP to the policy
    quantum (occupancy is never understated), then add a deterministic
    offset in [0, quantum) keyed by (seed, metric, viewer, quantized
    value). Same true state => same report, so deterministic CI can
    still gate on it — but the offset carries no information about the
    sub-quantum truth and cannot be averaged out across observations.

    Module-level so every tenant-facing surface (lighthouse scoped
    views, the span tracer's ``tenant_summary``) hardens through the
    SAME transform."""
    q = max(1, int(quantum))
    v = (int(value) + q - 1) // q * q
    if policy.noise and q > 1:
        h = hashlib.sha256(
            f"{policy.seed}:{metric}:{viewer_tier}:{v}".encode()).digest()
        v += int.from_bytes(h[:4], "little") % q
    return v


class Lighthouse:
    def __init__(self, registry, heartbeat_timeout_s: float = 5.0,
                 telemetry_policy: TelemetryPolicy | None = None):
        self.registry = registry
        self.timeout = heartbeat_timeout_s
        self.telemetry_policy = telemetry_policy or TelemetryPolicy()
        self.clock = 0.0
        self._last_beat: dict[str, float] = {}
        self._cache: list = []
        self.crashed = False
        # fault injection: a stale lighthouse keeps serving but its
        # telemetry intake is frozen — reports drop, readers see the
        # last published counters (FaultPlan kind "telemetry_stale")
        self.stale = False
        self.discovery_queries = 0
        self._pool_stats: dict[str, dict] = {}
        self._migration_stats: dict[str, dict] = {}
        self._saturation = 0.0       # engine-published overload level
        hook = getattr(registry, "add_teardown_hook", None)
        if hook is not None:
            hook(self.detach)

    def detach(self, island_id: str):
        """Drop an island's liveness + telemetry state (registry teardown
        hook, also called on island failure): a gone island must not keep
        a live heartbeat, stale pool telemetry, or a slot in the crashed-
        LIGHTHOUSE fallback cache."""
        self._last_beat.pop(island_id, None)
        self._pool_stats.pop(island_id, None)
        self._migration_stats.pop(island_id, None)
        self._cache = [i for i in self._cache if i.island_id != island_id]

    def advance(self, dt: float):
        self.clock += dt

    def heartbeat(self, island_id: str):
        if island_id in self.registry:
            self._last_beat[island_id] = self.clock

    def announce(self, island_id: str):
        """Island coming online (laptop wake, car start)."""
        self.heartbeat(island_id)

    def is_alive(self, island_id: str) -> bool:
        t = self._last_beat.get(island_id)
        return t is not None and (self.clock - t) <= self.timeout

    # --------------------------------------------------------- telemetry
    def report_pool(self, island_id: str, stats: dict):
        """Publish a SHORE island's KV page-pool counters (occupancy,
        prefix-share hit rate, COW copies, blocked admissions — plus the
        chunked-prefill signals ``prefill_backlog``, prompt tokens not yet
        prefilled, and ``prefix_tokens_skipped``, prompt FLOPs avoided via
        prefix sharing) with a heartbeat timestamp; ``pool_telemetry()``
        is the mesh-wide view the dashboards/benchmarks read."""
        if self.stale:
            return
        if island_id in self.registry:
            self._pool_stats[island_id] = dict(stats, reported_at=self.clock)

    def report_saturation(self, level: float):
        """Publish the engine's mesh overload level (0..1 fraction of
        the configured shed watermark — 1.0 means the engine is
        shedding). The raw value is operator-view; tenants read it only
        through ``mesh_saturation(viewer_tier=...)``, hardened."""
        if not self.stale:
            self._saturation = max(0.0, float(level))

    def mesh_saturation(self, viewer_tier: int | None = None) -> int:
        """Mesh saturation as an integer percent. Raw for the operator
        (``viewer_tier=None``); scoped viewers get it quantized UP to
        ``quantum_saturation_pct`` with value-keyed noise — the same
        ``harden_value`` transform as every other tenant-facing value,
        so the backpressure hint WAVES backs off on (never understated,
        can trip early) carries no sub-quantum load information."""
        pct = int(round(self._saturation * 100))
        if viewer_tier is None or not self.telemetry_policy.tier_scoped:
            return pct
        return self._report_value(
            "mesh_saturation", pct,
            self.telemetry_policy.quantum_saturation_pct, viewer_tier)

    def _report_value(self, metric: str, value: int, quantum: int,
                      viewer_tier: int) -> int:
        return harden_value(self.telemetry_policy, metric, value,
                            quantum, viewer_tier)

    def mesh_prefill_backlog(self, viewer_tier: int | None = None) -> int:
        """Total undispatched prefill tokens across reporting islands.
        With ``viewer_tier`` set, only tiers the viewer may see contribute
        and the sum is quantized/noised per the telemetry policy."""
        if viewer_tier is None:
            return sum(int(s.get("prefill_backlog", 0))
                       for s in self._pool_stats.values())
        if not self.telemetry_policy.tier_scoped:
            return self.mesh_prefill_backlog()
        total = 0
        for s in self._pool_stats.values():
            for t, d in (s.get("tiers") or {}).items():
                if isinstance(t, int) and t >= viewer_tier:
                    total += int(d.get("prefill_backlog", 0))
        return self._report_value("mesh_prefill_backlog", total,
                                  self.telemetry_policy.quantum_tokens,
                                  viewer_tier)

    def pool_telemetry(self, viewer_tier: int | None = None) -> dict:
        """Mesh pool telemetry.

        ``viewer_tier=None`` (orchestrator/operator) returns the raw
        per-island dicts. ``viewer_tier=t`` returns the tier-scoped tenant
        view: ONE mesh-wide aggregate summing each island's per-tier rows
        over tiers visible to the viewer (tier' >= t — its own tier and
        less-sensitive ones), quantized + value-key-noised. The scoped
        view deliberately omits per-island resolution, untiered/system
        pages, and all work-clock counters."""
        if viewer_tier is None:
            return {iid: dict(s) for iid, s in self._pool_stats.items()}
        if not self.telemetry_policy.tier_scoped:
            return self.pool_telemetry()
        agg = {"pages_in_use": 0, "share_hits": 0, "share_misses": 0,
               "prefill_backlog": 0}
        for s in self._pool_stats.values():
            for t, d in (s.get("tiers") or {}).items():
                if not isinstance(t, int) or t < viewer_tier:
                    continue
                for k in agg:
                    agg[k] += int(d.get(k, 0))
        pol = self.telemetry_policy
        return {
            "viewer_tier": viewer_tier,
            "pages_in_use": self._report_value(
                "pages_in_use", agg["pages_in_use"], pol.quantum_pages,
                viewer_tier),
            "share_hits": self._report_value(
                "share_hits", agg["share_hits"], pol.quantum_pages,
                viewer_tier),
            "share_misses": self._report_value(
                "share_misses", agg["share_misses"], pol.quantum_pages,
                viewer_tier),
            "prefill_backlog": self._report_value(
                "prefill_backlog", agg["prefill_backlog"],
                pol.quantum_tokens, viewer_tier),
        }

    def report_migration(self, island_id: str, stats: dict):
        """Publish an island's cumulative migration counters (requests
        thawed by KV-page import vs recompute fallback, data pages shipped,
        same-tier prefix re-attach hits on import). The per-island dicts
        are cumulative; ``mesh_migration_stats()`` is the mesh-wide sum the
        churn benchmark gates on."""
        if self.stale:
            return
        if island_id in self.registry:
            self._migration_stats[island_id] = dict(stats,
                                                    reported_at=self.clock)

    def mesh_migration_stats(self) -> dict:
        out = {"imports": 0, "imported_pages": 0, "import_attach_hits": 0,
               "recomputes": 0, "import_tier_mismatch": 0}
        for s in self._migration_stats.values():
            for k in out:
                out[k] += int(s.get(k, 0))
        return out

    def migration_telemetry(self) -> dict:
        return {iid: dict(s) for iid, s in self._migration_stats.items()}

    def get_islands(self) -> list:
        """Live, routable islands; cached list when crashed (conservative
        fallback). Draining/failed islands heartbeat but take no new work,
        so discovery excludes them."""
        if self.crashed:
            return list(self._cache)
        self.discovery_queries += 1
        routable = getattr(self.registry, "is_routable", None)
        alive = [i for i in self.registry.all()
                 if self.is_alive(i.island_id)
                 and (routable is None or routable(i.island_id))]
        self._cache = alive
        return alive
