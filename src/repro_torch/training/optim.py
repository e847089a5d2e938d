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
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


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
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(like)


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


def _use_factored(cfg, shape):
    return cfg.factored and len(shape) >= 2


def init_state(cfg: AdamWConfig, params):
    dt = getattr(torch, cfg.state_dtype)

    def one(p):
        z = dict(dtype=dt, device=p.device)
        if _use_factored(cfg, p.shape):
            return {"m": torch.zeros(p.shape, **z),
                    "vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"m": torch.zeros(p.shape, **z),
                "v": torch.zeros(p.shape, **z)}

    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"mu": tree_map(one, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def state_axes(cfg: AdamWConfig, params_axes):
    """Logical axes for the optimizer state mirroring the param axes (a
    tree of tuples beside the params)."""
    def one(ax):
        ax = tuple(ax)
        if cfg.factored and len(ax) >= 2:
            return {"m": ax, "vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
        return {"m": ax, "v": ax}

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return one(node)

    return {"mu": walk(params_axes), "step": ()}


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


def _update(cfg, p, g, s, rank, lr, scale, bc1, bc2):
    """One leaf's new parameter and state, the reference's ``one``."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    m = b1 * s["m"].float() + (1 - b1) * g
    if "v" in s:
        v = b2 * s["v"].float() + (1 - b2) * g * g
        vhat = v / bc2
        new = {"m": m, "v": v}
    else:
        g2 = g * g
        vr = b2 * s["vr"].float() + (1 - b2) * g2.mean(-1)
        vc = b2 * s["vc"].float() + (1 - b2) * g2.mean(-2)
        denom = torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
        vhat = (vr[..., None] * vc[..., None, :] / denom[..., None]) / bc2
        new = {"m": m, "vr": vr, "vc": vc}
    upd = (m / bc1) / (torch.sqrt(vhat) + cfg.eps)
    if (p.dim() if rank is None else rank) >= 2:
        upd = upd + cfg.weight_decay * p.float()
    return ((p.float() - lr * upd).to(p.dtype),
            {k: x.to(s[k].dtype) for k, x in new.items()})


def _ranks_or_none(ranks, params):
    return ranks if ranks is not None else tree_map(lambda p: None, params)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, ranks=None):
    """Returns (new params, new state, {"lr", "grad_norm"}); the norm is
    the gradients' before clipping."""
    step, lr, scale, bc1, bc2, gnorm = _scalars(cfg, grads, state)
    out = tree_map(lambda p, g, s, r: _update(cfg, p, g, s, r, lr, scale,
                                              bc1, bc2),
                   params, grads, state["mu"], _ranks_or_none(ranks, params))
    new_params = tree_map(lambda p, o: o[0], params, out)
    new_mu = tree_map(lambda p, o: o[1], params, out)
    return new_params, {"mu": new_mu, "step": step}, {
        "lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def apply_updates_(cfg: AdamWConfig, params, grads, state, ranks=None,
                   grad_norm=None):
    """``apply_updates`` in place: the same values written into
    ``params`` and ``state``, one leaf at a time. ``grad_norm``: the
    gradients' global norm when ``grads`` hold only this rank's shards.
    Returns (params, state, {"lr", "grad_norm"})."""
    step, lr, scale, bc1, bc2, gnorm = _scalars(cfg, grads, state,
                                                grad_norm)

    def one(p, g, s, r):
        new_p, new_s = _update(cfg, p, g, s, r, lr, scale, bc1, bc2)
        p.copy_(new_p)
        for k, x in new_s.items():
            s[k].copy_(x)

    tree_map(one, params, grads, state["mu"], _ranks_or_none(ranks, params))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
