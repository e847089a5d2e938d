"""Deterministic observability layer of the PyTorch/CUDA port (see
``repro_torch``); port of ``repro/obs/__init__.py``.

Three clocks, one convention:

* **tick** — the orchestrator/batcher scheduling tick the event fell in;
* **work** — the deterministic work clock (tokens the model actually
  dispatched). Checks gate ONLY on tick/work quantities;
* **wall_ns** — ``time.perf_counter_ns()`` at emission. Profiling only,
  never gated.

The tracer (``obs.trace``) is an **operator-view** surface: it sits on
the same trust boundary as the Lighthouse's ``viewer_tier=None`` raw
telemetry. Nothing in it may be forwarded to a tenant except through
``Tracer.tenant_summary``, which routes every value through the mesh
``TelemetryPolicy`` hardening (quantize + value-keyed noise) exactly as
the lighthouse does.
"""
from repro_torch.obs.metrics import (MetricsRegistry,
                                     collect_batcher_metrics,
                                     latency_summary, percentile, summarize,
                                     ttft_stats)
from repro_torch.obs.profile import DispatchProfiler
from repro_torch.obs.trace import Tracer
from repro_torch.obs.export import chrome_trace_events, write_chrome_trace

__all__ = [
    "DispatchProfiler", "MetricsRegistry", "Tracer",
    "chrome_trace_events", "collect_batcher_metrics", "latency_summary",
    "percentile", "summarize", "ttft_stats", "write_chrome_trace",
]
