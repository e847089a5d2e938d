"""Shared layer primitives + parameter-table machinery.

Port of ``repro/models/layers.py``. Every block defines a *parameter
table*: a nested dict mapping name -> ``PSpec(shape, logical_axes,
init)``; ``init_params`` draws real tensors from one table with an
explicit ``torch.Generator``, following the reference's rules (normal
scaled by fan_in^-1/2, zero-init norms, explicit scales such as the
embedding's 0.02, Mamba-2's ``dt_bias``/``a_log``/``ones``, the RG-LRU's
``lambda_init``). The draws are the port's own: a ``torch.Generator``
gives other numbers than ``jax.random`` for the same seed, so parity tests
move the reference's weights across with ``repro_torch.bridge`` instead.

``param_axes`` and ``abstract_params`` derive a table's logical axes and
its abstract (meta-device) tensors, so that real params, abstract params
and sharding specs come from one table. Under a mesh ``init_params``
takes ``keep``, which maps each whole drawn leaf to what this rank keeps
(its local shard): every rank draws the same numbers as one process.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import (column_in, gather_out, model_offset,
                                  model_ranks, row_out)


@dataclass(frozen=True)
class PSpec:
    shape: tuple
    axes: tuple  # logical axis names (len == len(shape))
    init: str = "normal"  # normal|zeros|ones|dt_bias|a_log|lambda_init
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _walk(table, prefix=()):
    """(path, PSpec) leaves of a nested table, keys sorted (the reference's
    pytree flattening order)."""
    for k in sorted(table):
        v = table[k]
        if isinstance(v, PSpec):
            yield prefix + (k,), v
        else:
            yield from _walk(v, prefix + (k,))


def init_params(table, generator: torch.Generator, dtype, device,
                keep=None):
    """Real tensors for every leaf of ``table``, drawn in flattening order
    from ``generator`` (which must live on ``device``). ``keep(path, w)``,
    when given, replaces each whole leaf (at ``path``, a tuple of keys)
    by what to keep of it."""
    out: dict = {}
    for path, spec in _walk(table):
        if spec.init == "zeros":
            w = torch.zeros(spec.shape, dtype=dtype, device=device)
        elif spec.init == "ones":
            w = torch.ones(spec.shape, dtype=dtype, device=device)
        elif spec.init == "lambda_init":
            # RG-LRU Lambda: a ~ U[0.9, 0.999] -> its softplus inverse at
            # c = 8, so that a = exp(-8 softplus(Lambda))
            u = (torch.rand(spec.shape, generator=generator,
                            dtype=torch.float32, device=device)
                 * (0.999 - 0.9) + 0.9)
            w = torch.log(torch.expm1(-torch.log(u) / 8.0)).to(dtype)
        elif spec.init == "dt_bias":
            # Mamba-2 dt bias: softplus^-1 of dt ~ U[1e-3, 1e-1]
            u = (torch.rand(spec.shape, generator=generator,
                            dtype=torch.float32, device=device)
                 * (1e-1 - 1e-3) + 1e-3)
            w = torch.log(torch.expm1(u)).to(dtype)
        elif spec.init == "a_log":
            # Mamba-2 A = -(1..n): A_log = log(1..n)
            w = torch.log(torch.arange(1, math.prod(spec.shape) + 1,
                                       dtype=torch.float32,
                                       device=device)
                          ).reshape(spec.shape).to(dtype)
        elif spec.init == "normal":
            scale = spec.scale
            if scale is None:
                fan_in = (spec.shape[-2] if len(spec.shape) >= 2
                          else spec.shape[-1])
                scale = fan_in ** -0.5
            w = (torch.randn(spec.shape, generator=generator,
                             dtype=torch.float32, device=device)
                 * scale).to(dtype)
        else:
            raise ValueError(f"init {spec.init!r} belongs to a block family "
                             f"the port does not carry yet")
        if keep is not None:
            w = keep(path, w)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = w
    return out


def _map_table(table, fn):
    return {k: (fn(v) if isinstance(v, PSpec) else _map_table(v, fn))
            for k, v in table.items()}


def abstract_params(table, dtype):
    """Meta tensors of every leaf's shape and ``dtype``: no storage."""
    return _map_table(table, lambda s: torch.empty(s.shape, dtype=dtype,
                                                   device="meta"))


def param_axes(table):
    return _map_table(table, lambda s: s.axes)


# ---------------------------------------------------------------- primitives

def rms_norm(x, w, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def rope_freqs(head_dim, theta, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """x: (..., S, H, D); positions: (..., S) int. Split-half rotation
    (the first D/2 lanes pair with the last D/2), as the reference."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (d/2,)
    angles = positions[..., None].float() * freqs              # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu_table(d_model, d_ff, ff_axis="ff"):
    return {
        "w_gate": PSpec((d_model, d_ff), (None, ff_axis)),
        "w_up": PSpec((d_model, d_ff), (None, ff_axis)),
        "w_down": PSpec((d_ff, d_model), (ff_axis, None)),
    }


def rms_norm_split(x, w, total, eps=1e-6):
    """``rms_norm`` over a last dim split over "model": ``x`` and ``w``
    are this rank's ``x.shape[-1]`` of ``total`` lanes, the squares summed
    over the ranks (the reference's gated norm over all of Mamba-2's
    inner width). The whole sum is read by each rank's split lanes, so
    its gradient is summed over "model" too."""
    x32 = x.float()
    var = column_in(row_out(torch.sum(x32 * x32, dim=-1,
                                      keepdim=True))) / total
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def split_heads(t, heads, width):
    """A projection's output ``t`` (..., cols) as (..., h, width): this
    rank's ``h`` heads where its columns are whole heads (the model axis
    divides ``heads``), every head otherwise, its columns gathered over
    "model" where the rules split them mid-head."""
    if t.shape[-1] != heads * width and heads % model_ranks():
        t = gather_out(t, -1)
    return t.reshape(t.shape[:-1] + (t.shape[-1] // width, width))


def row_parallel(o, w, split):
    """``o @ w`` for an output projection whose rows ``w`` may be this
    rank's slice (the rules split them over "model"): ``o`` holds this
    rank's heads (``split``) or every head, of which the rank's rows are
    taken; the partial products summed over "model"."""
    if w.shape[0] == o.shape[-1]:
        y = torch.matmul(o, w)
        return row_out(y) if split else y
    o = column_in(o).narrow(-1, model_offset(w.shape[0]), w.shape[0])
    return row_out(torch.matmul(o, w))


def swiglu_apply(p, x, ff=None):
    """Weights are stored (d_in, d_out), as the reference: ``x @ W``.
    ``ff`` is the global hidden width: where this rank holds fewer
    (``w_down`` split over "model"), ``w_gate``/``w_up`` are
    column-parallel and ``w_down`` row-parallel, summed over "model"."""
    split = ff is not None and p["w_down"].shape[0] != ff
    xi = column_in(x) if split else x
    g = torch.matmul(xi, p["w_gate"])
    u = torch.matmul(xi, p["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.matmul(h, p["w_down"])
    return row_out(y) if split else y
