"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427].

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t),  a_t = exp(-c*softplus(L)*r_t)

Port of ``repro/models/rglru.py``. Prefill runs the recurrence through
the hand-written kernel ``repro_torch.kernels.rglru.rglru_scan`` (K6),
which computes the reference's ``lru_scan`` one step at a time where the
reference takes an associative scan; decode is the O(1) state update, in
PyTorch as in the reference. The gates (block-diagonal or dense), the
causal conv and the output projection are plain matmuls and elementwise
ops. GELU is the tanh form, ``jax.nn.gelu``'s default.

The block's cache is ``{"conv", "h"}``: the last ``conv_width - 1``
PRE-conv features (B, W-1, lru_width) in the cache dtype (bf16 on the
serving paths) and the state (B, lru_width) in fp32. Caches are updated
IN PLACE (the reference returns new, donated arrays).

Tensor parallel over "model" (``sharding.LOCAL_RULES``): where the model
axis divides ``lru_width``, ``wx``, ``wy``, ``conv`` and ``wo`` hold this
rank's channels (``wo`` row-parallel, summed over "model" after it) and
K6 runs on them; the rank reads its channels of the replicated ``lam``.
Block-diagonal gates are the rank's blocks and stay local where the
model axis divides the blocks; where it does not, they are replicated,
``u`` is gathered over "model", the whole block-diagonal gate applied
and the rank's channels kept. Dense (r, r) gates hold the rank's output
columns and read all of ``u``, which is gathered over "model" before
them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import rglru_scan
from repro_torch.models.layers import PSpec, rms_norm
from repro_torch.models.ssm import causal_conv
from repro_torch.sharding import column_in, gather_out, model_offset, row_out

C_RGLRU = 8.0


def rglru_table(cfg):
    d, r, W = cfg.d_model, cfg.lru_width, cfg.conv_width
    t = {
        "ln": PSpec((d,), (None,), "zeros"),
        "wx": PSpec((d, r), (None, "lru")),
        "wy": PSpec((d, r), (None, "lru")),
        "conv": PSpec((W, r), (None, "lru"), scale=0.5),
        "lam": PSpec((r,), (None,), "lambda_init"),
        "wo": PSpec((r, d), ("lru", None)),
    }
    nb = cfg.lru_diag_blocks
    if nb:
        # Griffin's block-diagonal gates: nb independent (bs, bs) blocks
        bs = r // nb
        t["w_rg"] = PSpec((nb, bs, bs), ("lru", None, None),
                          scale=bs ** -0.5)
        t["w_ig"] = PSpec((nb, bs, bs), ("lru", None, None),
                          scale=bs ** -0.5)
    else:
        t["w_rg"] = PSpec((r, r), (None, "lru"))
        t["w_ig"] = PSpec((r, r), (None, "lru"))
    return t


def rglru_cache_spec(cfg, batch, max_len=None):
    """{name: (shape, logical axes)} of this block's decode cache (its
    size does not depend on ``max_len``)."""
    r, W = cfg.lru_width, cfg.conv_width
    return {"conv": ((batch, W - 1, r), ("batch", None, "lru")),
            "h": ((batch, r), ("batch", "lru"))}


def _gate(u, w):
    """u (B, S, r) through a block-diagonal (nb, bs, bs) or a dense
    (r, r) gate matrix, as fp32."""
    if w.dim() == 3:
        B, S, r = u.shape
        nb, bs, _ = w.shape
        g = torch.einsum("bsnk,nkj->bsnj", u.reshape(B, S, nb, bs), w)
        return g.reshape(B, S, r).float()
    return torch.matmul(u, w).float()


def rglru_gates(p, u):
    """u (B, S, r) conv output -> (a fp32, gated fp32)."""
    r_g = torch.sigmoid(_gate(u, p["w_rg"]))
    i_g = torch.sigmoid(_gate(u, p["w_ig"]))
    log_a = -C_RGLRU * F.softplus(p["lam"].float()) * r_g
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = beta * i_g * u.float()
    return a, gated


def _gates_split(p, u, rl):
    """``rglru_gates`` on this rank's ``rl`` channels ``u`` (B, S, rl) of
    a width split over "model": block-diagonal gates are the rank's
    blocks, or, replicated where the axis does not divide the blocks,
    applied whole to ``u`` gathered over "model" (the rank's channels
    kept); a dense gate holds the rank's columns and reads ``u``
    gathered over "model"."""
    lam = column_in(p["lam"]).narrow(0, model_offset(rl), rl)

    def gate(w):
        if w.dim() == 3 and w.shape[0] * w.shape[1] == rl:
            return _gate(u, w)               # the rank's blocks
        whole = column_in(gather_out(u, -1))
        if w.dim() == 3:                     # every block, on every rank
            return _gate(whole, column_in(w)).narrow(-1, model_offset(rl),
                                                     rl)
        return torch.matmul(whole, w).float()

    r_g = torch.sigmoid(gate(p["w_rg"]))
    i_g = torch.sigmoid(gate(p["w_ig"]))
    log_a = -C_RGLRU * F.softplus(lam.float()) * r_g
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i_g * u.float()


def lru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t over axis 1. a, b (B, S, r) fp32; h0
    (B, r) or None. The reference's associative scan, here K6."""
    return rglru_scan(a.contiguous(), b.contiguous(), h0)


def rglru_apply(cfg, p, x, positions, *, mode, cache=None):
    """RG-LRU block. mode 'full' (x (B, S, d); ``cache`` None or this
    layer's ``{"conv", "h"}``, whose state seeds the scan and which takes
    the prompt's conv tail and final state) or 'decode' (x (B, 1, d)
    against ``cache``). ``positions`` are not read: the state carries the
    position. Returns (x + out, cache)."""
    W = cfg.conv_width
    rl = p["wx"].shape[1]                        # this rank's channels
    split = rl != cfg.lru_width
    gates = ((lambda p_, u_: _gates_split(p_, u_, rl)) if split
             else rglru_gates)
    hin = rms_norm(x, p["ln"])
    if split:
        hin = column_in(hin)
    y_branch = F.gelu(torch.matmul(hin, p["wy"]).float(), approximate="tanh")
    pre = torch.matmul(hin, p["wx"])             # pre-conv (B, S, r)

    if mode == "full":
        S = x.shape[1]
        u = causal_conv(pre, p["conv"])
        a, gated = gates(p, u)
        h0 = cache["h"].float() if cache is not None else None
        h = lru_scan(a, gated, h0)
        if cache is not None:
            # the conv tail is the last W-1 PRE-conv features, zeros
            # before a prompt shorter than that
            tail = (pre[:, -(W - 1):] if S >= W - 1 else
                    F.pad(pre, (0, 0, W - 1 - S, 0)))
            cache["conv"].copy_(tail)
            cache["h"].copy_(h[:, -1])
    elif mode == "decode":                       # one token
        window = torch.cat([cache["conv"].to(pre.dtype), pre], dim=1)
        u = torch.einsum("bwr,wr->br", window, p["conv"])[:, None, :]
        a, gated = gates(p, u)
        h = (a[:, 0] * cache["h"].float() + gated[:, 0])[:, None, :]
        cache["conv"].copy_(window[:, 1:])
        cache["h"].copy_(h[:, 0])
    else:
        raise ValueError(f"rglru block: no mode {mode!r} (paged chunk runs "
                         f"are attention-only)")

    out = (h * y_branch).to(x.dtype)
    out = torch.matmul(out, p["wo"])
    return x + (row_out(out) if split else out), cache
