"""Chrome-trace / Perfetto JSON export of a ``Tracer`` journal.

Layout: each island is a **process** (pid), with thread 0 as its queue
/ lifecycle track and one **thread per slot** for residency spans; the
orchestrator is pid 0 with routing/terminal events on thread 0.
Migrations render as flow arrows (``s``/``f`` pairs) from the source
island's lifecycle track to the destination's.

Timestamps are the wall-ns stamps converted to µs relative to the first
event — the one place wall clock is the right axis, since Perfetto is a
profiling UI. The deterministic stamps ride along in every event's
``args`` (``tick``, ``work``) so a span can be read in any of the three
clocks.

Load the output at https://ui.perfetto.dev or chrome://tracing. This is
an operator-view artifact: it names islands and requests, so it crosses
the same trust boundary as raw lighthouse telemetry — never ship it to
a tenant.
"""
from __future__ import annotations

import json


def _us(e, t0):
    return (e.wall_ns - t0) / 1000.0


def _args(e):
    return {"tick": e.tick, "work": e.work, **e.attrs}


def chrome_trace_events(tracer) -> list:
    """Flatten a Tracer journal into a ``traceEvents`` list."""
    evs = tracer.events
    if not evs:
        return []
    t0 = min(e.wall_ns for e in evs)
    out = []
    pids = {None: 0}
    for i, iid in enumerate(tracer.islands()):
        pids[iid] = i + 1

    def meta(pid, name, tid=None, tname=None):
        if tid is None:
            out.append({"ph": "M", "pid": pid, "name": "process_name",
                        "args": {"name": name}})
        else:
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name", "args": {"name": tname}})

    meta(0, "orchestrator")
    meta(0, None, tid=0, tname="routing")
    for iid, pid in pids.items():
        if iid is None:
            continue
        meta(pid, f"island:{iid}")
        meta(pid, None, tid=0, tname="lifecycle")

    slot_tids: dict = {}          # (pid, slot) -> tid

    def slot_tid(pid, slot):
        key = (pid, slot)
        if key not in slot_tids:
            tid = slot + 1
            slot_tids[key] = tid
            meta(pid, None, tid=tid, tname=f"slot {slot}")
        return slot_tids[key]

    # open request-residency spans: (pid, rid) -> slot tid
    open_res: dict = {}
    # queue spans: (pid, rid) open at queue/thaw_queue, closed at admit
    open_q: dict = {}
    flow_id = 0
    pending_out: dict = {}        # rid -> (event, flow_id) awaiting _in

    for e in evs:
        pid = pids.get(e.island, 0)
        ts = _us(e, t0)
        if e.kind in ("queue", "thaw_queue"):
            out.append({"ph": "B", "pid": pid, "tid": 0, "ts": ts,
                        "name": f"queued r{e.rid}", "args": _args(e)})
            open_q[(pid, e.rid)] = True
        elif e.kind == "admit":
            if open_q.pop((pid, e.rid), None):
                out.append({"ph": "E", "pid": pid, "tid": 0, "ts": ts})
            slot = e.attrs.get("slot")
            if slot is not None:
                tid = slot_tid(pid, slot)
                open_res[(pid, e.rid)] = tid
                out.append({"ph": "B", "pid": pid, "tid": tid, "ts": ts,
                            "name": f"r{e.rid}", "args": _args(e)})
        elif e.kind in ("finish", "exec_reject", "freeze", "preempt"):
            tid = open_res.pop((pid, e.rid), None)
            if tid is not None:
                out.append({"ph": "E", "pid": pid, "tid": tid, "ts": ts})
            out.append({"ph": "i", "pid": pid, "tid": tid or 0, "ts": ts,
                        "s": "t", "name": e.kind, "args": _args(e)})
        elif e.kind in ("prefill", "first_token", "decode", "page_alloc",
                        "page_cow", "page_share"):
            tid = open_res.get((pid, e.rid), 0) if e.rid is not None \
                else 0
            out.append({"ph": "i", "pid": pid, "tid": tid, "ts": ts,
                        "s": "t", "name": e.kind, "args": _args(e)})
        elif e.kind == "migrate_out":
            src_pid = pids.get(e.attrs.get("island"), 0)
            flow_id += 1
            pending_out[e.rid] = flow_id
            out.append({"ph": "s", "pid": src_pid, "tid": 0, "ts": ts,
                        "id": flow_id, "name": f"migrate r{e.rid}",
                        "cat": "migration", "args": _args(e)})
        elif e.kind in ("migrate_in", "migrate_return"):
            dst_pid = pids.get(e.attrs.get("island"), 0)
            fid = pending_out.pop(e.rid, None)
            if fid is not None:
                out.append({"ph": "f", "pid": dst_pid, "tid": 0,
                            "ts": ts, "id": fid, "bp": "e",
                            "name": f"migrate r{e.rid}",
                            "cat": "migration", "args": _args(e)})
        elif e.island is None:
            # orchestrator routing / terminal / failover journal
            out.append({"ph": "i", "pid": 0, "tid": 0, "ts": ts,
                        "s": "t", "name": e.kind, "args": _args(e)})
        else:
            out.append({"ph": "i", "pid": pid, "tid": 0, "ts": ts,
                        "s": "t", "name": e.kind, "args": _args(e)})

    # close anything still open so the JSON is well-formed for viewers
    t_end = max(_us(e, t0) for e in evs) + 1.0
    for (pid, _rid) in list(open_q):
        out.append({"ph": "E", "pid": pid, "tid": 0, "ts": t_end})
    for (pid, _rid), tid in open_res.items():
        out.append({"ph": "E", "pid": pid, "tid": tid, "ts": t_end})
    return out


def write_chrome_trace(tracer, path: str) -> int:
    """Write the journal as Chrome-trace JSON; returns the event count."""
    events = chrome_trace_events(tracer)
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms",
                   "metadata": {"clock_note":
                                "ts is wall-us; args carry tick/work"}},
                  f)
    return len(events)
