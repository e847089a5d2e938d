"""Per-tick dispatch profiler: where does a serving tick's wall time go?

Port of ``repro/obs/profile.py``. The profiler splits each batcher tick
into phases so the host-plan vs device-execute split is visible:

* ``host_plan``   — pure-Python scheduling: admission, chunk planning,
  page table updates, stream bookkeeping (derived: tick total minus the
  measured phases below);
* ``bucket``      — pow2 shape-bucket lookup/registration;
* ``dispatch_submit`` — time spent *inside* the model calls as observed
  from the host: staging the host arrays onto the device and issuing
  every eager kernel launch of the forward pass (the device runs behind
  the host, so this is launch time, not device time);
* ``device_sync`` — the host's waits on the device: the explicit
  ``torch.cuda.synchronize`` the profiler issues at tick end, so that
  in-flight work is charged to the tick that launched it, AND every
  token readback inside the tick (the unfused and stochastic paths' and
  a full prefill's sampled tokens, a fused slot's device-resident tail
  at finish, freeze and preemption). The reference leaves those
  readbacks in the derived ``host_plan``; on the card they wait for the
  device's queue to drain, so booking them as host planning would read
  device time as host time. On the greedy fused path readbacks happen
  only at finish, freeze and preemption.

All numbers are wall-clock ns and therefore NEVER gated — the
deterministic side of profiling is the shape counters, which are exact.
The profiler's end-of-tick sync changes when the host waits, never what
the device computes: token streams and the work clock are unaffected.

Usage::

    prof = DispatchProfiler()
    batcher.profiler = prof        # or orchestrator-wide via batchers
    ... run ticks ...
    prof.report()   # phase totals + fractions + per-tick p50/p95
"""
from __future__ import annotations

import time

import torch

from repro_torch.obs.metrics import summarize


def _first_tensor(tree):
    """The first tensor of a nested list / tuple / dict of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else tree
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


class DispatchProfiler:
    """Accumulates per-tick phase timings and dispatch-shape counters
    for one batcher. Attach one profiler per batcher — phase state is
    tick-scoped and not reentrant."""

    PHASES = ("host_plan", "bucket", "dispatch_submit", "device_sync")

    def __init__(self):
        self.ticks: list[dict] = []      # one record per profiled tick
        self.totals = {p: 0 for p in self.PHASES}
        self.total_ns = 0
        self.shape_counts: dict[tuple, int] = {}
        self.dispatches = 0
        self._cur: dict | None = None
        self._tick_t0 = 0

    # ---------------------------------------------------- tick framing
    def tick_begin(self):
        self._cur = {p: 0 for p in self.PHASES}
        self._cur["dispatches"] = 0
        self._tick_t0 = time.perf_counter_ns()

    def tick_end(self, sync_target=None):
        """Close the tick: when ``sync_target`` (a tensor or a nested
        structure of them) lies on a CUDA device, synchronize that device
        (charged to ``device_sync``); on the CPU there is nothing to wait
        for. The residual folds into ``host_plan``."""
        cur = self._cur
        if cur is None:
            return
        t = _first_tensor(sync_target) if sync_target is not None else None
        if t is not None and t.device.type == "cuda":
            t0 = time.perf_counter_ns()
            torch.cuda.synchronize(t.device)
            cur["device_sync"] += time.perf_counter_ns() - t0
        total = time.perf_counter_ns() - self._tick_t0
        measured = (cur["bucket"] + cur["dispatch_submit"]
                    + cur["device_sync"])
        cur["host_plan"] = max(total - measured, 0)
        cur["total"] = total
        for p in self.PHASES:
            self.totals[p] += cur[p]
        self.total_ns += total
        self.dispatches += cur["dispatches"]
        self.ticks.append(cur)
        self._cur = None

    # -------------------------------------------------- phase charging
    def phase(self, name: str):
        """Context manager charging its block to ``name`` in the current
        tick (no-op outside a tick)."""
        return _Phase(self, name)

    def add_ns(self, name: str, ns: int, dispatches: int = 0):
        if self._cur is not None:
            self._cur[name] += ns
            self._cur["dispatches"] += dispatches

    def note_shapes(self, entries):
        """Record dispatch-shape tuples (from ``batcher.dispatch_shapes``
        slices). First sighting of a shape == one new launch geometry."""
        for s in entries:
            key = tuple(s)
            self.shape_counts[key] = self.shape_counts.get(key, 0) + 1

    # ----------------------------------------------------------- report
    def report(self) -> dict:
        """Phase totals (ms), fractions of profiled wall time, per-tick
        total p50/p95, and the deterministic shape counters."""
        out = {"ticks": len(self.ticks), "dispatches": self.dispatches,
               "total_ms": round(self.total_ns / 1e6, 3)}
        for p in self.PHASES:
            out[f"{p}_ms"] = round(self.totals[p] / 1e6, 3)
            out[f"{p}_frac"] = round(self.totals[p] / self.total_ns, 4) \
                if self.total_ns else 0.0
        out.update(summarize(
            [round(t["total"] / 1e6, 3) for t in self.ticks], "tick_ms"))
        out["unique_shapes"] = len(self.shape_counts)
        out["shape_dispatches"] = sum(self.shape_counts.values())
        return out


class _Phase:
    __slots__ = ("prof", "name", "t0")

    def __init__(self, prof, name):
        self.prof, self.name = prof, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.prof.add_ns(self.name, time.perf_counter_ns() - self.t0)
        return False
