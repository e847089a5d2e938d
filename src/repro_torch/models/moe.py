"""Mixture-of-Experts block.

Port of ``repro/models/moe.py``'s ``dense`` path, the one the reference
serves with no mesh (``moe.py:134-135``): every expert applied to every
token, combined with the routing weights of the token's top-k experts.
The expert FFNs are three broadcasting ``torch.matmul`` calls of the
(T, d) tokens against the stacked (E, d, f) / (E, f, d) expert weights,
the counterpart of the reference's einsums over ``broadcast_to(x2[None],
(E, T, d))``; the tokens are never copied E times. No Pallas kernel is
involved in the reference, and none here.

The capacity-bounded expert-parallel dispatch (``_rank_within_expert``,
``_moe_local``) needs a mesh and waits for ROADMAP P13.

``moe_apply`` counts its calls in ``moe_apply.calls`` (as the kernel
wrappers count ``.launches``), so a serving run can show how many MoE
layers each dispatch went through.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (PSpec, rms_norm, swiglu_apply,
                                       swiglu_table)


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


def moe_apply(cfg, p, x):
    """x (B, S, d) -> (y (B, S, d) [residual NOT added], aux scalar)."""
    moe_apply.calls += 1
    B, S, d = x.shape
    h = rms_norm(x, p["ln"])
    x2 = h.reshape(B * S, d)
    y, aux = _moe_dense(p, x2, cfg.top_k, cfg.num_experts)
    y = y.reshape(B, S, d)
    if cfg.num_shared_experts:
        y = y + swiglu_apply(p["shared"], h)
    return y, aux


moe_apply.calls = 0
