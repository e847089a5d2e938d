"""Batched WAVES routing for one scheduling tick, on tensors.

Port of ``repro/core/routing_jax.py`` (``pack_islands``,
``pack_requests``, ``route_batch``, ``pack_tide_state``,
``unpack_tide_state``, ``route_batch_tick`` and ``pareto_front``). The
scalar Algorithm-1 path in ``waves.py`` is the oracle: the batched router
is decision-equivalent to routing the same requests one by one at a
frozen clock.

``route_batch`` answers, for every request at once, which island it would
pick from a frozen capacity snapshot: one (requests x islands) pass of
tensor ops on the tables' device, with no read back to the host.

``route_batch_tick`` is a sequential greedy pass — request i sees the
capacity left over by requests 0..i-1 — so the reference's
``lax.fori_loop`` becomes a Python loop over rows, each row a handful of
(n,)-wide float32 tensor ops on the orchestrator's device. Nothing in the
loop reads a value back to the host; the caller moves the results across
once per tick.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.tide import (DEAD_ZONE as _DEAD_ZONE,
                                   LOAD_MIX as _LOAD_MIX,
                                   QUEUE_FACTOR as _QUEUE_FACTOR,
                                   RECOVERY_CAP as _RECOVERY_CAP)

BIG = 1e30

# The router accumulates load in float32 while the scalar oracle uses
# Python floats; a capacity that lands EXACTLY on a tier gate can fall on
# opposite sides of >= in the two precisions. Admission comparisons get
# this slack so boundary ties resolve the same way as the f64 oracle.
CAP_EPS = 1e-6

_F32 = torch.float32


@dataclass(frozen=True)
class IslandTable:
    privacy: torch.Tensor        # (n,)
    cost: torch.Tensor           # (n,) $
    latency: torch.Tensor        # (n,) ms
    capacity: torch.Tensor       # (n,) R_j(t)
    trust: torch.Tensor          # (n,)
    tier: torch.Tensor           # (n,) int
    unbounded: torch.Tensor      # (n,) bool
    datasets: torch.Tensor       # (n, n_datasets) bool
    alive: torch.Tensor          # (n,) bool


def pack_islands(islands, dataset_ids, tide, trust_mode="min",
                 device="cpu"):
    idx = {d: i for i, d in enumerate(dataset_ids)}
    ds = np.zeros((len(islands), max(len(dataset_ids), 1)), bool)
    for j, isl in enumerate(islands):
        for d in isl.datasets:
            if d in idx:
                ds[j, idx[d]] = True

    def t(vals, dtype=_F32):
        return torch.tensor(vals, dtype=dtype, device=device)

    return IslandTable(
        privacy=t([i.privacy for i in islands]),
        cost=t([i.cost_per_request for i in islands]),
        latency=t([tide.effective_latency_ms(i) for i in islands]),
        capacity=t([tide.capacity(i.island_id) for i in islands]),
        trust=t([i.trust(trust_mode) for i in islands]),
        tier=t([i.tier for i in islands], torch.int32),
        unbounded=t([i.unbounded for i in islands], torch.bool),
        datasets=torch.from_numpy(ds).to(device),
        alive=torch.ones((len(islands),), dtype=torch.bool, device=device),
    )


def pack_requests(sens, priority_gate, deadline_ms=None, dataset=None,
                  personal_only=None, n_datasets=1, device="cpu"):
    """sens (m,), priority_gate (m,) capacity thresholds per request,
    dataset (m,) int ids (-1 = none), personal_only (m,) bool (primary
    tier: local-regardless-of-pressure semantics). Each a sequence or a
    tensor (moved to ``device``, as the routed serve step passes them)."""
    m = len(sens)

    def t(vals, dtype):
        if isinstance(vals, torch.Tensor):
            return vals.to(device=device, dtype=dtype)
        return torch.tensor(vals, dtype=dtype, device=device)

    return {
        "sens": t(sens, _F32),
        "gate": t(priority_gate, _F32),
        "deadline": (t(deadline_ms, _F32) if deadline_ms is not None
                     else torch.full((m,), float("inf"), dtype=_F32,
                                     device=device)),
        "dataset": (t(dataset, torch.int32) if dataset is not None
                    else torch.full((m,), -1, dtype=torch.int32,
                                    device=device)),
        "personal_only": (t(personal_only, torch.bool)
                          if personal_only is not None
                          else torch.zeros((m,), dtype=torch.bool,
                                           device=device)),
    }


def _f32_reciprocal(x, dev):
    return torch.reciprocal(torch.tensor(x, dtype=_F32, device=dev))


def route_batch(tbl: IslandTable, reqs, weights, *, mode="scalarized",
                budget=float("inf"), min_trust=0.0, cost_scale=0.05,
                latency_scale=2000.0):
    """Returns (assign (m,) int32 [-1 infeasible], feasible (m,) bool,
    score matrix (m, n) float32: the score where feasible, else ``BIG``),
    as tensors on the tables' device. ``weights`` is (w_cost, w_latency,
    w_privacy), a sequence or a (3,) tensor; ``mode="constraint"`` scores
    by normalised latency alone."""
    dev = tbl.privacy.device
    w1, w2, w3 = weights[0], weights[1], weights[2]
    sens = reqs["sens"][:, None]                          # (m, 1)
    ok = tbl.alive[None, :] & (tbl.privacy[None, :] >= sens)  # hard privacy
    ok = ok & (tbl.unbounded[None, :]
               | (tbl.capacity[None, :] >= reqs["gate"][:, None]))
    ok = ok & (tbl.latency[None, :] <= reqs["deadline"][:, None])
    ok = ok & (tbl.cost[None, :] <= budget)
    ok = ok & (tbl.trust[None, :] >= min_trust)
    ok = ok & torch.where(reqs["personal_only"][:, None],
                          (tbl.tier == 1)[None, :], True)
    has_ds = reqs["dataset"] >= 0
    ds_hit = tbl.datasets.t()[torch.clamp(reqs["dataset"], min=0).long()]
    ok = ok & torch.where(has_ds[:, None], ds_hit, True)   # (m, n)

    # the reference's jit folds the default scales into constants, which
    # XLA divides by as products with their float32 reciprocals: the same
    # products here give its scores bit for bit
    cn = torch.clamp(tbl.cost * _f32_reciprocal(cost_scale, dev), max=1.0)
    ln = torch.clamp(tbl.latency * _f32_reciprocal(latency_scale, dev),
                     max=1.0)
    if mode == "constraint":
        score = ln[None, :].expand(ok.shape)
    else:
        score = (w1 * cn + w2 * ln + w3 * (1.0 - tbl.privacy))[
            None, :].expand(ok.shape)
    masked = torch.where(ok, score.to(_F32),
                         torch.tensor(BIG, dtype=_F32, device=dev))
    assign = torch.argmin(masked, dim=1).to(torch.int32)
    feasible = torch.any(ok, dim=1)
    assign = torch.where(feasible, assign, -1).to(torch.int32)
    return assign, feasible, masked


def pack_tide_state(islands, tide, device="cpu"):
    """Per-island *dynamic* state consumed by route_batch_tick: resource
    utilization (cpu/gpu/mem), inflight work, hysteresis flags, base latency
    and the per-assignment work cost 1/capacity_units.

    A crashed TIDE fails conservative exactly like the scalar path: bounded
    islands pack as fully utilized (R=0, no admission) with zero inflight
    and zero work cost."""
    sts = [tide._st(i.island_id) for i in islands]
    n = len(islands)

    def t(vals, dtype=_F32):
        return torch.tensor(vals, dtype=dtype, device=device)

    if tide.crashed:
        cpu = gpu = mem = torch.ones((n,), dtype=_F32, device=device)
        inflight = w_unit = torch.zeros((n,), dtype=_F32, device=device)
    else:
        cpu = t([s.cpu for s in sts])
        gpu = t([s.gpu for s in sts])
        mem = t([s.mem for s in sts])
        inflight = t([s.inflight for s in sts])
        w_unit = t([1.0 / max(i.capacity_units, 1e-6) for i in islands])
    return {
        "cpu": cpu,
        "gpu": gpu,
        "mem": mem,
        "inflight": inflight,
        "local_ok": t([s.local_ok for s in sts], torch.bool),
        "base_latency": t([i.latency_ms for i in islands]),
        "w_unit": w_unit,
    }


def unpack_tide_state(state, islands, tide):
    """Write a router-final state (host numpy arrays or tensors) back into
    TIDE so cross-tick dynamics continue from where the batch left off."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    if tide.crashed:
        # only the hysteresis flags are real
        lok = host(state["local_ok"])
        for j, isl in enumerate(islands):
            tide._st(isl.island_id).local_ok = bool(lok[j])
        return
    cpu = host(state["cpu"])
    gpu = host(state["gpu"])
    mem = host(state["mem"])
    infl = host(state["inflight"])
    lok = host(state["local_ok"])
    for j, isl in enumerate(islands):
        st = tide._st(isl.island_id)
        st.cpu = float(cpu[j])
        st.gpu = float(gpu[j])
        st.mem = float(mem[j])
        st.inflight = float(infl[j])
        st.local_ok = bool(lok[j])


def route_batch_tick(tbl: IslandTable, reqs, weights, state, extra_ok, *,
                     mode="scalarized", on_infeasible="reject",
                     budget=float("inf"), min_trust=0.0, cost_scale=0.05,
                     latency_scale=2000.0):
    """Capacity-aware batched routing for one scheduling tick.

    ``weights`` is a (3,) float32 tensor (w_cost, w_latency, w_privacy);
    ``extra_ok`` an (m, n) bool mask carrying the request×island
    constraints outside the packed tables (model family, jurisdiction).

    Returns ``(assign, accepted, queued, score, n_candidates, new_state)``
    as tensors on the tables' device: assign (m,) int32 island index or
    -1; queued marks requests placed by the ``queue_local`` fallback;
    score is the scalarized composite of the chosen island; new_state is
    the post-batch TIDE state to write back via unpack_tide_state.
    """
    dev = tbl.privacy.device
    m = reqs["sens"].shape[0]
    n = tbl.privacy.shape[0]
    w1, w2, w3 = weights[0], weights[1], weights[2]
    base_lat = state["base_latency"]
    w_unit = state["w_unit"]
    big = torch.tensor(BIG, dtype=_F32, device=dev)
    cn = torch.clamp(tbl.cost / cost_scale, max=1.0)
    static_ok = tbl.alive & (tbl.cost <= budget) & (tbl.trust >= min_trust)
    idx_n = torch.arange(n, dtype=torch.int32, device=dev)
    cpu, gpu, mem = state["cpu"], state["gpu"], state["mem"]
    infl, lok = state["inflight"], state["local_ok"]
    assign = torch.full((m,), -1, dtype=torch.int32, device=dev)
    acc = torch.zeros((m,), dtype=torch.bool, device=dev)
    que = torch.zeros((m,), dtype=torch.bool, device=dev)
    sco = torch.full((m,), -1.0, dtype=_F32, device=dev)
    ncand = torch.zeros((m,), dtype=torch.int32, device=dev)
    priv_ok_all = tbl.tier == 1
    for i in range(m):
        sens_i = reqs["sens"][i]
        gate_i = reqs["gate"][i]
        prim_i = reqs["personal_only"][i]
        ds_i = reqs["dataset"][i]
        # hard filters, in the scalar _eligible order: everything BEFORE the
        # capacity check gates whether an island's hysteresis state is
        # even consulted (the scalar path early-returns)
        pre = static_ok & (tbl.privacy >= sens_i)
        pre = pre & torch.where(prim_i, priv_ok_all, True)
        # index_select, not a 0-d tensor index, which reads it back to
        # the host (and fails on meta tensors)
        ds_col = tbl.datasets.index_select(
            1, torch.clamp(ds_i, min=0).long().reshape(1))[:, 0]
        pre = pre & torch.where(ds_i >= 0, ds_col, True)
        pre = pre & extra_ok[i]
        pre = pre & (base_lat <= reqs["deadline"][i])
        # capacity admission with hysteresis (TIDE.admits): bounded islands
        # fall back when R drops under the tier gate and only recover a
        # DEAD_ZONE above it; primary bypasses, unbounded always admits
        r = 1.0 - torch.maximum(cpu, torch.maximum(gpu, mem))
        recov = torch.clamp(gate_i + _DEAD_ZONE, max=_RECOVERY_CAP)
        cap_ok = torch.where(lok, r >= gate_i - CAP_EPS,
                             r >= recov - CAP_EPS)
        ok = pre & (tbl.unbounded | prim_i | cap_ok)
        touched = pre & ~tbl.unbounded & ~prim_i
        lok = torch.where(touched, cap_ok, lok)
        # queueing-aware latency: inflight work accumulated THIS tick
        # inflates a bounded island's effective latency before scoring
        eff_lat = torch.where(tbl.unbounded, base_lat,
                              base_lat * (1.0 + _QUEUE_FACTOR * infl))
        ln = torch.clamp(eff_lat / latency_scale, max=1.0)
        s_comp = w1 * cn + w2 * ln + w3 * (1.0 - tbl.privacy)
        score = eff_lat if mode == "constraint" else s_comp
        masked = torch.where(ok, score, big)
        j = torch.argmin(masked).to(torch.int32)
        feas = torch.any(ok)
        if on_infeasible == "queue_local":
            okq = tbl.alive & priv_ok_all & (tbl.privacy >= sens_i)
            jq = torch.argmin(torch.where(okq, s_comp, big)).to(torch.int32)
            hasq = torch.any(okq)
            que_i = ~feas & hasq
            j = torch.where(feas, j, jq)
            acc_i = feas | hasq
        else:
            que_i = torch.zeros((), dtype=torch.bool, device=dev)
            acc_i = feas
        # account the chosen island's load (TIDE.add_load, bounded only)
        # so the NEXT request in this tick sees the decremented capacity
        hot = (idx_n == j) & acc_i & ~tbl.unbounded
        gpu = torch.where(hot, torch.clamp(gpu + _LOAD_MIX["gpu"] * w_unit,
                                           max=1.0), gpu)
        cpu = torch.where(hot, torch.clamp(cpu + _LOAD_MIX["cpu"] * w_unit,
                                           max=1.0), cpu)
        mem = torch.where(hot, torch.clamp(mem + _LOAD_MIX["mem"] * w_unit,
                                           max=1.0), mem)
        infl = torch.where(hot, infl + w_unit, infl)
        assign[i] = torch.where(acc_i, j, -1)
        acc[i] = acc_i
        que[i] = que_i
        sco[i] = torch.where(acc_i, s_comp.index_select(
            0, j.long().reshape(1))[0], -1.0)
        ncand[i] = torch.sum(ok).to(torch.int32)
    new_state = dict(state, cpu=cpu, gpu=gpu, mem=mem, inflight=infl,
                     local_ok=lok)
    return assign, acc, que, sco, ncand, new_state


def pareto_front(tbl: IslandTable):
    """Non-dominated islands in (cost, latency, 1-privacy) space: (n,)
    bool on the tables' device."""
    objs = torch.stack([tbl.cost, tbl.latency, 1.0 - tbl.privacy], dim=1)
    le = torch.all(objs[:, None, :] <= objs[None, :, :], dim=-1)
    lt = torch.any(objs[:, None, :] < objs[None, :, :], dim=-1)
    dominated = torch.any(le & lt, dim=0)  # someone dominates j
    return ~dominated
