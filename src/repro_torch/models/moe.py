"""Mixture-of-Experts block.

Port of ``repro/models/moe.py``'s ``dense`` path, the one the reference
serves with no mesh (``moe.py:134-135``): every expert applied to every
token, combined with the routing weights of the token's top-k experts.
The expert FFNs are three broadcasting ``torch.matmul`` calls of the
(T, d) tokens against the stacked (E, d, f) / (E, f, d) expert weights,
the counterpart of the reference's einsums over ``broadcast_to(x2[None],
(E, T, d))``; the tokens are never copied E times. No Pallas kernel is
involved in the reference, and none here.

Under a mesh with a "model" axis (``sharding.axis_rules``) the block
takes the reference's ``expert_parallel`` path (``moe.py:136-170``): the
experts are sharded over "model" (each rank holds ``E / model`` of them,
``Model.init`` under the mesh), the tokens are this rank's rows (split
over the data axes that divide the batch, ``sharding.batch_split_axes``;
the whole batch where none does, as the reference replicates it), and
``_moe_local`` is the reference's ``shard_map`` body run per rank:
each rank dispatches its tokens to its local experts through a
capacity-bounded scatter (``_rank_within_expert``; entries over
capacity or on another rank's experts are dropped), runs the expert FFNs
as one batched matmul, gathers back, and an all-reduce SUM over "model"
combines the experts' contributions. The load-balance loss takes global
routing statistics: the counts summed and the mean probabilities averaged
over the data axes that split the batch. Over a batch that no data axis
splits, each rank routes every token and takes no data groups, and its
capacity counts every token, as the reference's, which drops the batch
axes there (``moe.py:142-146``). Where the batch does not split but its
tokens would (B % data != 0, B*S % data == 0), the reference sizes the
capacity for a token share and the port for every token: only drops
differ (ROADMAP G3).

Gradients: ``torch.distributed.all_reduce`` has no backward, and an
all-reduce that is differentiated sums again in its backward. The region
is bracketed by a conjugate pair of autograd Functions instead:
``_Enter`` (identity forward, all-reduce SUM backward over "model") on
the tokens the experts read and on the routing weights, and ``_Leave``
(all-reduce SUM forward, identity backward) on the combined output and
on the data-averaged probabilities. Each rank's gradient of a replicated
input is then the single-device gradient, which is also what the
reference's sharded gradient equals.

The shared experts' ff is split over "model" as the dense MLP's is
(``layers.swiglu_apply``: column- then row-parallel); the router is
replicated.

``moe_apply`` counts its calls in ``moe_apply.calls`` (as the kernel
wrappers count ``.launches``), so a serving run can show how many MoE
layers each dispatch went through, and the expert-parallel path's
forward all-reduces in ``moe_apply.all_reduces``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.layers import (PSpec, rms_norm, swiglu_apply,
                                       swiglu_table)
from repro_torch.sharding import batch_split_axes, current_mesh, mesh_shape


def moe_table(cfg):
    E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    t = {
        "ln": PSpec((d,), (None,), "zeros"),
        "router": PSpec((d, E), (None, None), scale=d ** -0.5),
        "we_gate": PSpec((E, d, f), ("experts", None, None)),
        "we_up": PSpec((E, d, f), ("experts", None, None)),
        "we_down": PSpec((E, f, d), ("experts", None, None)),
    }
    if cfg.num_shared_experts:
        t["shared"] = swiglu_table(d, cfg.num_shared_experts * f)
    return t


def _route(logits, k):
    """fp32 logits (T, E) -> (weights (T, k), idx (T, k), probs (T, E)).
    The top k in ``jax.lax.top_k``'s order: descending, and the lower
    expert index first among equal probabilities (a stable sort; the
    order of ``torch.topk`` among ties is unspecified)."""
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # renormalise
    return w, idx, probs


def _aux_loss(probs, idx, E):
    """Switch-style load-balance loss: E * sum_e f_e * p_e. The counts are
    an ``index_add_`` of ones (exact in fp32 in any order); ``bincount``
    would read its maximum back to the host on the card."""
    flat = idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=probs.device)
    counts.index_add_(0, flat, torch.ones(flat.shape[0], dtype=torch.float32,
                                          device=probs.device))
    f = counts / torch.clamp(counts.sum(), min=1.0)
    p = probs.mean(dim=0)
    return E * torch.sum(f * p)


def _expert_ffn(weg, weu, wed, buf):
    """buf (E, C, d), or (C, d) broadcast over the experts -> (E, C, d)."""
    g = torch.matmul(buf, weg)
    u = torch.matmul(buf, weu)
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.matmul(h, wed)


def _moe_dense(p, x2, k, E):
    logits = torch.matmul(x2, p["router"]).float()
    w, idx, probs = _route(logits, k)
    outs = _expert_ffn(p["we_gate"], p["we_up"], p["we_down"], x2)
    # outs: (E, T, d); combine the top k
    tok = torch.arange(x2.shape[0], device=x2.device)[:, None]
    sel = outs[idx, tok]                                   # (T, k, d)
    y = torch.einsum("tk,tkd->td", w.to(sel.dtype), sel)
    return y, _aux_loss(probs, idx, E)


def _rank_within_expert(eid_flat):
    """eid_flat (N,) int -> rank of each entry among equal expert ids, in
    entry order (a stable sort)."""
    n = eid_flat.shape[0]
    order = torch.argsort(eid_flat, stable=True)
    sorted_eid = eid_flat[order]
    starts = torch.searchsorted(sorted_eid, sorted_eid, side="left")
    rank_sorted = (torch.arange(n, device=eid_flat.device)
                   - starts).to(torch.int32)
    rank = torch.empty(n, dtype=torch.int32, device=eid_flat.device)
    rank[order] = rank_sorted
    return rank


def _all_reduce(t, group):
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class _Enter(torch.autograd.Function):
    """Into the expert-parallel region: identity forward, all-reduce SUM
    of the gradient over the group backward (each rank's region sees only
    its local experts' share of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Leave(torch.autograd.Function):
    """Out of the region: all-reduce SUM forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        moe_apply.all_reduces += 1
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _moe_local(p_router, weg, weu, wed, x2, *, k, E, E_loc, C, m, group,
               data_groups=(), data_n=1):
    """One rank's part (the reference's ``shard_map`` body): x2 (T_loc,
    d) this rank's tokens, replicated over "model"; the expert weights
    its local slices (E_loc, ...); ``m`` its model rank, ``group`` the
    model group, ``data_groups`` the groups of the data axes (``data_n``
    ranks in all) over which the routing statistics are global."""
    T, d = x2.shape
    logits = torch.matmul(x2, p_router).float()
    w, idx, probs = _route(logits, k)                            # (T, k)
    w = _Enter.apply(w, group)
    xe = _Enter.apply(x2, group)
    rank = _rank_within_expert(idx.reshape(-1)).reshape(T, k)
    local = (idx >= m * E_loc) & (idx < (m + 1) * E_loc) & (rank < C)
    # flat buffer row of each (token, choice); dropped ones (not local, or
    # over capacity) land on a dump row past the E_loc * C real ones, which
    # the scatter writes and the gather reads as zeros
    row = torch.where(local, (idx - m * E_loc) * C + rank,
                      torch.full_like(idx, E_loc * C))
    buf = torch.zeros(E_loc * C + 1, d, dtype=x2.dtype, device=x2.device)
    for ki in range(k):
        buf = buf.index_add(0, row[:, ki], xe)
    out = _expert_ffn(weg, weu, wed, buf[:E_loc * C].reshape(E_loc, C, d))
    out = torch.cat([out.reshape(E_loc * C, d),
                     torch.zeros(1, d, dtype=out.dtype, device=out.device)])
    y = torch.zeros(T, d, dtype=torch.float32, device=x2.device)
    for ki in range(k):
        y = y + w[:, ki:ki + 1] * out[row[:, ki]].float()
    y = _Leave.apply(y, group)
    # load-balance loss over GLOBAL routing statistics (matches the dense
    # oracle): aggregate counts/probs across batch shards first
    flat = idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=x2.device)
    counts.index_add_(0, flat, torch.ones(flat.shape[0], dtype=torch.float32,
                                          device=x2.device))
    p_mean = probs.mean(dim=0)
    for data_group in data_groups:
        counts = _all_reduce(counts, data_group)
        moe_apply.all_reduces += 1
        p_mean = _Leave.apply(p_mean, data_group)
    p_mean = p_mean / data_n
    f = counts / torch.clamp(counts.sum(), min=1.0)
    aux = E * torch.sum(f * p_mean)
    return y.to(x2.dtype), aux


def capacity(cfg, tokens: int) -> int:
    """Expert capacity a rank for ``tokens`` local tokens."""
    return max(4, int(math.ceil(tokens * cfg.top_k / cfg.num_experts
                                * cfg.capacity_factor)))


def moe_apply(cfg, p, x):
    """x (B, S, d) -> (y (B, S, d) [residual NOT added], aux scalar).
    Without a mesh the dense path; under one with a "model" axis the
    expert-parallel path on this rank's tokens and local experts."""
    moe_apply.calls += 1
    B, S, d = x.shape
    h = rms_norm(x, p["ln"])
    x2 = h.reshape(B * S, d)
    mesh = current_mesh()
    k, E = cfg.top_k, cfg.num_experts
    sizes = mesh_shape(mesh) if mesh is not None else {}
    if "model" not in sizes:
        y, aux = _moe_dense(p, x2, k, E)
    else:
        model_size = sizes["model"]
        if E % model_size:
            raise ValueError(f"moe_apply: {E} experts do not split over a "
                             f"model axis of {model_size}")
        E_loc = E // model_size
        if p["we_gate"].shape[0] != E_loc:
            raise ValueError(f"moe_apply: this rank holds "
                             f"{p['we_gate'].shape[0]} experts, the mesh "
                             f"gives it {E_loc} (init or shard the params "
                             f"under the same mesh)")
        data = batch_split_axes(mesh)
        y, aux = _moe_local(
            p["router"], p["we_gate"], p["we_up"], p["we_down"], x2, k=k,
            E=E, E_loc=E_loc, C=capacity(cfg, B * S),
            m=mesh.get_local_rank("model"), group=mesh.get_group("model"),
            data_groups=[mesh.get_group(ax) for ax in data],
            data_n=math.prod(sizes[ax] for ax in data))
    y = y.reshape(B, S, d)
    if cfg.num_shared_experts:
        y = y + swiglu_apply(p["shared"], h,
                             ff=cfg.num_shared_experts * cfg.moe_d_ff)
    return y, aux


moe_apply.calls = 0
moe_apply.all_reduces = 0
