"""Counters and work-clock histograms for the serving stack.

One percentile implementation for the whole repo. The formula is the
historical one both ``engine.aggregate_stats`` and the serving
benchmark's TTFT stats used independently — ``sorted[min(n-1,
int(q*n))]`` — kept bit-for-bit so existing benchmark artifacts and
their gates are unchanged by the dedup (``int(0.5*n) == n//2`` exactly,
so the old ``lat[n // 2]`` p50 is this formula at q=0.5).

Histograms observe DETERMINISTIC quantities only (work-clock units,
ticks, pages, counts); wall-clock timings live in ``obs.profile`` and
never pass through here, so everything a ``MetricsRegistry`` snapshot
contains is CI-gateable.
"""
from __future__ import annotations

from typing import Iterable, Optional


def percentile(values: Iterable, q: float):
    """The repo-wide percentile: ``sorted(values)[min(n-1, int(q*n))]``.
    Returns None on an empty input (callers decide how absence reads)."""
    vals = sorted(values)
    n = len(vals)
    if n == 0:
        return None
    return vals[min(n - 1, int(q * n))]


def summarize(values: Iterable, name: str = "") -> dict:
    """n/min/max/p50/p95 summary of a value stream (empty -> {"n": 0}).
    ``name`` prefixes the keys so several summaries can merge flat."""
    vals = sorted(values)
    pre = f"{name}_" if name else ""
    if not vals:
        return {f"{pre}n": 0}
    return {f"{pre}n": len(vals),
            f"{pre}min": vals[0],
            f"{pre}max": vals[-1],
            f"{pre}p50": vals[min(len(vals) - 1, int(0.5 * len(vals)))],
            f"{pre}p95": vals[min(len(vals) - 1, int(0.95 * len(vals)))]}


def latency_summary(latencies: Iterable) -> dict:
    """The two latency percentiles ``aggregate_stats`` publishes, via the
    shared formula."""
    lat = sorted(latencies)
    if not lat:
        return {}
    return {"latency_p50": percentile(lat, 0.5),
            "latency_p95": percentile(lat, 0.95)}


def ttft_stats(request_log: dict, rids=None) -> dict:
    """p50 ticks/work to first token from a batcher's request log — the
    single implementation behind the serving benchmark's per-mode TTFT
    rows (work-TTFT is the CI-gated one: it exposes head-of-line
    blocking that virtual ticks cannot see)."""
    recs = [r for rid, r in request_log.items()
            if (rids is None or rid in rids) and "ttft_work" in r]
    if not recs:
        return {}
    return {"ttft_ticks_p50": percentile((r["ttft_ticks"] for r in recs),
                                         0.5),
            "ttft_work_p50": percentile((r["ttft_work"] for r in recs),
                                        0.5)}


class MetricsRegistry:
    """Named counters + histograms over deterministic quantities.

    ``counter(name)`` / ``inc(name, n)`` accumulate integers;
    ``observe(name, v)`` appends to a histogram whose snapshot reports
    the shared n/min/max/p50/p95 summary. A snapshot is a plain dict so
    benchmarks can embed it in their JSON artifacts directly.
    """

    def __init__(self):
        self.counters: dict[str, int] = {}
        self.hists: dict[str, list] = {}

    def inc(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        return self.counters.get(name, 0)

    def observe(self, name: str, value):
        self.hists.setdefault(name, []).append(value)

    def observe_many(self, name: str, values: Iterable):
        self.hists.setdefault(name, []).extend(values)

    def snapshot(self) -> dict:
        out = {"counters": dict(self.counters), "histograms": {}}
        for name, vals in self.hists.items():
            out["histograms"][name] = summarize(vals)
        return out


def jain_index(values: Iterable) -> float:
    """Jain's fairness index ``(sum x)^2 / (n * sum x^2)`` over per-tenant
    work-clock service. 1.0 = perfectly even; 1/n = one tenant has
    everything. Empty or all-zero inputs read as fair (1.0): fairness of
    nothing is not a violation."""
    vals = [float(v) for v in values]
    n = len(vals)
    if n == 0:
        return 1.0
    s = sum(vals)
    s2 = sum(v * v for v in vals)
    if s2 <= 0.0:
        return 1.0
    return (s * s) / (n * s2)


def collect_batcher_metrics(batcher,
                            registry: Optional[MetricsRegistry] = None
                            ) -> MetricsRegistry:
    """Fold one batcher's lifecycle records into a registry: TTFT and
    queue-wait histograms in both gateable clocks, per-request work-clock
    TPOT (work per generated token after the first), pool occupancy, and
    the migration/preemption counters. Everything comes from
    ``request_log`` + ``stats`` — no new instrumentation runs, so
    collection can never perturb serving."""
    reg = registry or MetricsRegistry()
    for rec in batcher.request_log.values():
        if "ttft_ticks" in rec:
            reg.observe("ttft_ticks", rec["ttft_ticks"])
            reg.observe("ttft_work", rec["ttft_work"])
        if "admit_tick" in rec:
            reg.observe("queue_wait_ticks",
                        rec["admit_tick"] - rec["submit_tick"])
        if "done_work" in rec and "ttft_work" in rec:
            # decode work past the first token, per decode token: the
            # work-clock TPOT (1.0 = this request never waited for
            # another request's tokens once decoding)
            span = rec["done_work"] - rec["submit_work"] - rec["ttft_work"]
            toks = max(rec.get("generated_tokens", 0) - 1, 1)
            reg.observe("tpot_work", span / toks)
        if rec.get("migrations"):
            reg.inc("migrated_requests")
            reg.inc("migrations", rec["migrations"])
    reg.inc("requests", len(batcher.request_log))
    reg.inc("preemptions", batcher.stats.get("preemptions", 0))
    pool = getattr(batcher, "pool", None)
    if pool is not None:
        reg.observe("pool_pages_peak", pool.stats["peak_in_use"])
        reg.observe("pool_occupancy_pct",
                    round(100.0 * pool.occupancy(), 1))
    return reg


def collect_orchestrator_metrics(orch,
                                 registry: Optional[MetricsRegistry] = None
                                 ) -> MetricsRegistry:
    """Mesh-level fold: every island batcher's metrics, plus the SLO-class
    and tenant-fairness accounting the orchestrator keeps (per-class
    work-clock TTFT/TPOT histograms, per-tenant service histogram, the
    min-over-run Jain index). Deterministic quantities only."""
    reg = registry or MetricsRegistry()
    for _iid, b in sorted(orch.batchers.items()):
        collect_batcher_metrics(b, reg)
    for tenant, svc in sorted(orch.tenant_service.items()):
        reg.observe("tenant_service_work", svc)
    reg.inc("tenants", len(orch.tenant_service))
    reg.observe("fairness_jain",
                jain_index(orch.tenant_service.values()))
    reg.observe("fairness_min_jain",
                orch.tick_stats.get("fairness_min_jain", 1.0))
    for cls, log in sorted(orch.class_log.items()):
        reg.observe_many(f"ttft_work[{cls}]", log["ttft_work"])
        reg.observe_many(f"tpot_work[{cls}]", log["tpot_work"])
        reg.inc(f"completed[{cls}]", log["completed"])
        reg.inc(f"expired[{cls}]", log["expired"])
        reg.inc(f"shed[{cls}]", log["shed"])
        reg.inc(f"rejected[{cls}]", log["rejected"])
    return reg
