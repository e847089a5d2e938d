"""AdamW with an optional factored second moment, global-norm clipping
and a cosine learning-rate schedule.

Port of ``repro/training/optim.py``. Parameters, gradients and the state
are nested dicts and lists of tensors (the port's parameter layout, or any
other tree); all arithmetic is fp32, as in the reference, and the scalars
(the step, the rate, the clip scale) stay 0-d tensors on the parameters'
device, so an update never reads back to the host. Weight decay is
decoupled and applies to matrices only; the factored second moment
(Adafactor-style row and column statistics) applies to tensors of rank 2
or more.

``apply_updates`` returns new trees, as the reference does;
``apply_updates_`` writes the same values into the parameters and the
state in place, which keeps a step at one copy of each (paligemma-3b's
fp32 weights and AdamW state are 40 GB: a second copy would not fit
beside them on an 80 GB card). ``state_axes`` maps the parameters'
logical sharding axes onto the state. A train step over a mesh, whose
ranks hold shards of some leaves, passes the global gradient norm in
(``grad_norm=``): a rank's own leaves would give only part of it.

In the reference a layer inside the repeating pattern groups is stacked
along a leading dim, so its 1-D leaves (norm weights) have rank 2 there
and take weight decay; the port keeps one tensor per layer. ``ranks``
(a tree of ints beside the parameters, from
``models.steps.reference_ranks``) gives the rank each leaf has in the
reference's layout, so that the decay falls on the same leaves.

The factored second moment follows the reference's layout too
(``groups``: for each pattern slot, the port's layers the reference
stacks into one leaf, from ``models.steps.stacked_groups``). A leaf of
rank 2 or more keeps its row and column statistics ``vr``/``vc`` beside
its ``m``: stacked, those are the reference's per-layer rows. A grouped
1-D leaf (rank 2 stacked) keeps only ``m`` per layer; its ``vr`` (one
mean of g^2 a layer) and ``vc`` (the mean over the group's layers) and
the ``denom`` (the mean of ``vr``) couple the group's layers, so they
live once a group in ``state["groups"][g]``, a tree of the layer's 1-D
leaves, computed from the group's gradients together. An ungrouped 1-D
leaf is not factored (rank 1 in the reference). Under a mesh a factored
leaf whose last or second-to-last dim is split (``split``: a tree of
``{dim: mesh axes}``, or None; "model", and with FSDP "pod" and "data")
takes those means, and the ``denom``, over the axes that split them, as
the reference's GSPMD sums them: the ranks' equal-sized local means
summed there and divided by their count, the mean over the global dim.
A grouped 1-D leaf split so takes its group's ``vr`` the same way.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.sharding import axes_mean


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    factored: bool = False      # factored 2nd moment for >=2D params
    state_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list, dict keys sorted, depth first
    (``jax.tree.leaves`` order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` from its leaves in ``tree_leaves``
    order."""
    return _unflatten(like, iter(leaves))


def _unflatten(node, it):
    # not a closure calling itself: that is a reference cycle, which would
    # keep ``leaves`` (a step's gradients) alive until the garbage
    # collector runs
    if isinstance(node, dict):
        return {k: _unflatten(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return [_unflatten(v, it) for v in node]
    return next(it)


def tree_map(fn, tree, *rest):
    """``fn`` on every tensor of ``tree`` and the nodes at the same paths
    of ``rest`` (which may hold whole sub-trees where ``tree`` has a
    tensor, as the state's ``mu`` does)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def cosine_lr(cfg: AdamWConfig, step):
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _use_factored(cfg, rank):
    return cfg.factored and rank >= 2


def _grouped(groups):
    """{layer index: the index of its group}."""
    return {i: g for g, layers in enumerate(groups or ()) for i in layers}


def _rank(leaf) -> int:
    """A leaf's rank: a tensor's or an array's dims, or the length of a
    logical-axes tuple."""
    return len(getattr(leaf, "shape", leaf))


def vector_paths(layer) -> list:
    """The key paths of a layer tree's 1-D leaves (tensors, arrays or
    axes tuples), in sorted order. In a grouped layer these are the
    leaves whose ``vr``/``vc`` live once a group."""
    out = []
    for k in sorted(layer):
        if isinstance(layer[k], dict):
            out += [(k,) + p for p in vector_paths(layer[k])]
        elif _rank(layer[k]) == 1:
            out.append((k,))
    return out


def nest(paths, fn) -> dict:
    """A tree holding ``fn(path)`` at each of ``paths``."""
    out = {}
    for path in paths:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = fn(path)
    return out


def at(tree, path):
    """The node of ``tree`` at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    at(tree, path[:-1])[path[-1]] = value


def _mirror(params, groups, leaf, vector=None):
    """A tree beside ``params``: ``leaf(p, its rank in the reference)``
    at every leaf, and with ``vector``, ``vector(p)`` at a grouped
    layer's 1-D leaves (``vector_paths``)."""
    where = _grouped(groups)
    if not where or not isinstance(params, dict) or "layers" not in params:
        return tree_map(lambda p: leaf(p, _rank(p)), params)
    out = {k: tree_map(lambda p: leaf(p, _rank(p)), v)
           for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for i, lp in enumerate(params["layers"]):
        e = int(i in where)
        t = tree_map(lambda p: leaf(p, _rank(p) + e), lp)
        if e and vector is not None:
            for path in vector_paths(lp):
                _set(t, path, vector(at(lp, path)))
        out["layers"].append(t)
    return out


def init_state(cfg: AdamWConfig, params, groups=None):
    """Zeroed AdamW state beside ``params``; factored, as set out above
    (``groups`` from ``models.steps.stacked_groups``; without them every
    leaf is factored by its own rank)."""
    dt = getattr(torch, cfg.state_dtype)

    def one(p, rank):
        z = dict(dtype=dt, device=p.device)
        if _use_factored(cfg, rank) and p.dim() >= 2:
            return {"m": torch.zeros(p.shape, **z),
                    "vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"m": torch.zeros(p.shape, **z),
                "v": torch.zeros(p.shape, **z)}

    def vector(p):          # its vr/vc are its group's
        return {"m": torch.zeros(p.shape, dtype=dt, device=p.device)}

    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    state = {"mu": _mirror(params, groups, one,
                           vector if cfg.factored else None),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.factored and groups:
        state["groups"] = []
        for layers in groups:
            lp = params["layers"][layers[0]]
            state["groups"].append(nest(vector_paths(lp), lambda path: {
                "vr": torch.zeros((len(layers),), dtype=dt, device=dev),
                "vc": torch.zeros(at(lp, path).shape, dtype=dt,
                                  device=dev)}))
    return state


def state_axes(cfg: AdamWConfig, params_axes, groups=None):
    """Logical axes for the optimizer state mirroring the param axes (a
    tree of tuples beside the params); with ``groups``, a grouped 1-D
    leaf's ``m`` and its group's ``vr`` ("layers") and ``vc``."""
    def one(ax, rank):
        ax = tuple(ax)
        if _use_factored(cfg, rank) and len(ax) >= 2:
            return {"m": ax, "vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
        return {"m": ax, "v": ax}

    def walk(node, extra):
        if isinstance(node, dict):
            return {k: walk(v, extra) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, extra) for v in node]
        return one(node, _rank(node) + extra)

    where = _grouped(groups)
    if not where:
        return {"mu": walk(params_axes, 0), "step": ()}
    mu = {k: walk(v, 0) for k, v in params_axes.items() if k != "layers"}
    mu["layers"] = [walk(lp, int(i in where))
                    for i, lp in enumerate(params_axes["layers"])]
    out = {"mu": mu, "step": ()}
    if cfg.factored:
        for i in where:
            lp = params_axes["layers"][i]
            for path in vector_paths(lp):
                _set(mu["layers"][i], path, {"m": tuple(at(lp, path))})
        out["groups"] = []
        for layers in groups:
            lp = params_axes["layers"][layers[0]]
            out["groups"].append(nest(vector_paths(lp), lambda path: {
                "vr": ("layers",), "vc": tuple(at(lp, path))}))
    return out


def _scalars(cfg, grads, state, gnorm=None):
    """(step, lr, clip scale, bias corrections 1 and 2, grad norm) of the
    update that follows ``state``: 0-d tensors."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    sf = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** sf
    bc2 = 1.0 - cfg.b2 ** sf
    return step, lr, scale, bc1, bc2, gnorm


def _mean(x, dim, split, ndim):
    """``x.mean(dim)`` of a tensor of ``ndim`` dims whose dims ``split``
    (``{dim: mesh axes}``, or None) names are split evenly over those
    axes: where ``dim`` is one, the mean over the global dim."""
    m = x.mean(dim)
    axes = (split or {}).get(dim % ndim)
    return axes_mean(m, axes) if axes else m


def _update(cfg, p, g, s, rank, lr, scale, bc1, bc2, vhat=None,
            split=None):
    """One leaf's new parameter and state, the reference's ``one``;
    ``vhat`` is a grouped 1-D leaf's second moment (its group's), and
    ``split`` the leaf's split dims (``{dim: mesh axes}``, or None)."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    m = b1 * s["m"].float() + (1 - b1) * g
    if "v" in s:
        v = b2 * s["v"].float() + (1 - b2) * g * g
        vhat = v / bc2
        new = {"m": m, "v": v}
    elif "vr" in s:
        g2 = g * g
        nd = g2.dim()
        vr = b2 * s["vr"].float() + (1 - b2) * _mean(g2, -1, split, nd)
        vc = b2 * s["vc"].float() + (1 - b2) * _mean(g2, -2, split, nd)
        # vr's dims are the leaf's but its last
        denom = torch.clamp(_mean(vr, -1, split, nd - 1).unsqueeze(-1),
                            min=1e-30)
        vhat = (vr[..., None] * vc[..., None, :] / denom[..., None]) / bc2
        new = {"m": m, "vr": vr, "vc": vc}
    else:
        new = {"m": m}
    upd = (m / bc1) / (torch.sqrt(vhat) + cfg.eps)
    if (p.dim() if rank is None else rank) >= 2:
        upd = upd + cfg.weight_decay * p.float()
    return ((p.float() - lr * upd).to(p.dtype),
            {k: x.to(s[k].dtype) for k, x in new.items()})


def _group_moments(cfg, grads, state, groups, scale, bc2, split=None):
    """The grouped 1-D leaves' second moments: (a tree beside the params
    with each such leaf's ``vhat`` and None elsewhere, the groups' new
    ``{vr, vc}``). ``vr`` (L,) and ``vc`` come from the group's L
    layers' gradients stacked, ``denom`` is ``vr``'s mean; a leaf split
    (``split``) takes ``vr``'s mean over its global length."""
    b2 = cfg.b2
    vh = tree_map(lambda g: None, grads)
    if "groups" not in state:
        return vh, None
    new_groups = []
    for layers, stats in zip(groups, state["groups"]):
        def one(path, layers=layers, stats=stats):
            st = at(stats, path)
            g2 = torch.stack([
                at(grads["layers"][i], path).float() * scale
                for i in layers]) ** 2                       # (L, n)
            axes = (at(split["layers"][layers[0]], path) or {}).get(0) \
                if split is not None else None
            vr = b2 * st["vr"].float() + (1 - b2) * _mean(
                g2, -1, axes and {1: axes}, 2)
            vc = b2 * st["vc"].float() + (1 - b2) * g2.mean(-2)
            denom = torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
            vhat = (vr[..., None] * vc[..., None, :] / denom[..., None]) \
                / bc2
            for j, i in enumerate(layers):
                _set(vh["layers"][i], path, vhat[j])
            return {"vr": vr.to(st["vr"].dtype), "vc": vc.to(st["vc"].dtype)}
        new_groups.append(nest(vector_paths(grads["layers"][layers[0]]),
                               one))
    return vh, new_groups


def _or_none(tree, params):
    return tree if tree is not None else tree_map(lambda p: None, params)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, ranks=None):
    """Returns (new params, new state, {"lr", "grad_norm"}); the norm is
    the gradients' before clipping. ``apply_updates_`` on copies."""
    return apply_updates_(cfg, tree_map(torch.clone, params), grads,
                          tree_map(torch.clone, state), ranks)


@torch.no_grad()
def apply_updates_(cfg: AdamWConfig, params, grads, state, ranks=None,
                   grad_norm=None, groups=None, split=None):
    """The AdamW step written into ``params`` and ``state`` in place,
    one leaf at a time. ``grad_norm``: the gradients' global norm when
    ``grads`` hold only this rank's shards; ``groups`` and ``split`` as
    for ``init_state`` and the module docstring. Returns (params, state,
    {"lr", "grad_norm"}), the norm the gradients' before clipping."""
    step, lr, scale, bc1, bc2, gnorm = _scalars(cfg, grads, state,
                                                grad_norm)
    vh, new_groups = _group_moments(cfg, grads, state, groups, scale, bc2,
                                    split)

    def one(p, g, s, r, v, d):
        new_p, new_s = _update(cfg, p, g, s, r, lr, scale, bc1, bc2, v, d)
        p.copy_(new_p)
        for k, x in new_s.items():
            s[k].copy_(x)

    tree_map(one, params, grads, state["mu"], _or_none(ranks, params),
             vh, _or_none(split, params))
    if new_groups is not None:
        tree_map(lambda s, n: s.copy_(n), state["groups"], new_groups)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
