"""Move the reference package's parameters into the port's layout.

The reference keeps a param pytree with the repeating layers stacked
along a leading dim (``params["blocks"]["slot{s}"][...]`` of shape
(n_groups, ...)) and any non-repeating layers as ``head_{i}`` /
``tail_{j}``; the port keeps one dict per layer in depth order
(``params["layers"][i]``). ``from_reference`` takes the reference's tree
with every leaf already a numpy array (``jax.tree.map(np.asarray,
params)`` on the caller's side — the port never imports JAX) and
``to_reference`` inverts it, so a round trip is exact. The maps are
generic over a layer's leaves: an MoE layer's ``moe`` dict (the
reference stacks its (E, d, f) experts to (G, E, d, f)), an MLA mixer,
and the dense first layers (``head_{i}``) cross like any other.

``shard_params`` takes the reference's parameters to this rank's local
slices under a mesh, placed as ``sharding.placed_axes`` places them (the
reference's rules; with FSDP, ``apply_fsdp``'s split over the data axes
too), as ``Model.init`` under the mesh keeps them.

``opt_state_from_reference`` carries the reference's AdamW state (its
``mu`` tree mirrors the reference's params) into the port's layout, so
that a train step can resume from it and the tests can compare states,
and ``opt_state_to_reference`` inverts it. A factored state crosses
too: a stacked leaf's ``vr``/``vc`` rows are per layer, except a
grouped 1-D leaf's, which are its group's (``state["groups"]``, in
pattern-slot order, as ``models.steps.stacked_groups``). Given a mesh
and the AdamW config, the pair takes a rank's slices of the state, as
``optim.state_axes`` places them beside the placed params: from the
reference's whole state, and (every rank gathering its shards) back.

``dense_cache_from_reference``/``dense_cache_to_reference`` do the same
for a dense decode cache (the reference's ``init_cache`` tree, whose
leaves sit under ``mixer``; the port's per-layer list of ``{"k", "v"}``
attention dicts, windowed rings included, MLA's ``{"ckr"}`` latents, and
``{"conv", "h"}`` SSM and RG-LRU dicts, bf16 ``conv`` and fp32 ``h`` as
the reference keeps them),
so that tests can compare caches. Layers outside the repeating cycles
(recurrentgemma-9b's ``tail_0``/``tail_1``) take their places in depth
order.

``ticket_to_reference`` and ``page_data_from_reference`` move the KV
payload of a migration ticket across for the tests. The port carries a
page record's data as one raw-bits array per cache leaf (each layer's
``k_pages`` then ``v_pages``, in depth order, bf16 as int16) and a dense
row the same way (each layer's ``{"k", "v"}``, ``{"ckr"}`` or
``{"conv", "h"}``); the
reference carries them in ``jax.tree.leaves`` order of its pool or dense
cache (sorted keys, the repeating layers stacked along a leading dim:
(G, page_size, Hkv, D) for a page leaf, (G, 1, max_len, ...) for a dense
row), with ml_dtypes bf16 host arrays. The ``like`` trees give the
reference's keys, shapes and dtypes.

numpy has no bfloat16: a bf16 leaf arrives as numpy's ml_dtypes
``bfloat16`` (or as ``uint16`` raw bits) and travels bit-exactly as
16-bit integers -> ``torch.Tensor.view(torch.bfloat16)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.model import effective_pattern
# the leaves of a nested dict in ``jax.tree.leaves`` order (sorted keys,
# depth first), and back
from repro_torch.training.optim import (at, nest, tree_leaves,
                                        tree_unflatten, vector_paths)


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def to_torch(a, device="cpu") -> torch.Tensor:
    """One numpy leaf -> tensor, bit-exact (bf16 through its uint16 bits)."""
    a = np.ascontiguousarray(a)
    if _is_bf16(a):
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def to_numpy(t: torch.Tensor, like: np.ndarray | None = None) -> np.ndarray:
    """One tensor -> numpy, bit-exact; bf16 returns ``like``'s dtype (the
    reference's ml_dtypes bfloat16) when given, else raw uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits.view(like.dtype) if like is not None else bits
    return t.numpy()


def _map(tree, fn):
    return {k: (_map(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _layer_order(cfg, ref_params):
    """(key, group_index_or_None) for every layer in depth order."""
    order = [(k, None) for k in sorted(
        (k for k in ref_params if k.startswith("head_")),
        key=lambda k: int(k.split("_")[1]))]
    if "blocks" in ref_params:
        pat = effective_pattern(cfg)
        n_groups = next(iter(_leaves(ref_params["blocks"]))).shape[0]
        for g in range(n_groups):
            for s in range(len(pat)):
                order.append((f"slot{s}", g))
    order += [(k, None) for k in sorted(
        (k for k in ref_params if k.startswith("tail_")),
        key=lambda k: int(k.split("_")[1]))]
    return order


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def from_reference(cfg, ref_params, device="cpu"):
    """The reference's numpy param tree -> the port's param dict."""
    out = {k: to_torch(v, device) for k, v in ref_params.items()
           if not isinstance(v, dict)}
    layers = []
    for key, g in _layer_order(cfg, ref_params):
        if g is None:
            layers.append(_map(ref_params[key], lambda a: to_torch(a, device)))
        else:
            layers.append(_map(ref_params["blocks"][key],
                               lambda a, g=g: to_torch(a[g], device)))
    out["layers"] = layers
    if len(layers) != cfg.num_layers:
        raise ValueError(f"bridged {len(layers)} layers, config has "
                         f"{cfg.num_layers}")
    return out


def shard_params(cfg, ref_params, mesh, device="cpu"):
    """The reference's numpy param tree -> this rank's local slices of
    the port's params under ``mesh`` and the current rules' placement
    (``sharding.placed_axes``; sliced on the host, then moved)."""
    from repro_torch import sharding
    from repro_torch.models.model import get_model
    from repro_torch.training.optim import tree_map
    full = from_reference(cfg, ref_params, "cpu")
    return tree_map(
        lambda t, ax: sharding.local_slice(t, ax, mesh).to(device), full,
        sharding.placed_axes(get_model(cfg), mesh))


def to_reference(cfg, params, like):
    """Invert ``from_reference``: the port's params -> a numpy tree in the
    reference's layout. ``like`` is the reference's numpy tree (it fixes
    the segment names and the bf16 dtype)."""
    out = {k: to_numpy(params[k], like[k]) for k in like
           if not isinstance(like[k], dict)}
    order = _layer_order(cfg, like)
    stacked: dict = {}
    for (key, g), layer in zip(order, params["layers"]):
        if g is None:
            out[key] = _map_pair(layer, like[key], to_numpy)
        else:
            stacked.setdefault(key, []).append(
                _map_pair(layer, like["blocks"][key],
                          lambda t, ref: to_numpy(t, ref)))
    if stacked:
        out["blocks"] = {k: _stack(v) for k, v in stacked.items()}
    return out


def _map_pair(tree, like, fn):
    return {k: (_map_pair(v, like[k], fn) if isinstance(v, dict)
                else fn(v, like[k])) for k, v in tree.items()}


def _stack(trees):
    first = trees[0]
    return {k: (_stack([t[k] for t in trees]) if isinstance(first[k], dict)
                else np.stack([t[k] for t in trees]))
            for k in first}


def opt_state_from_reference(cfg, ref_state, device="cpu", mesh=None,
                             opt_cfg=None):
    """The reference's AdamW state (``{"mu": ..., "step": ...}``, numpy
    leaves; ``mu`` mirrors its param tree with an ``{"m", "v"}`` or a
    factored ``{"m", "vr", "vc"}`` dict at every leaf) -> the port's
    (``mu`` mirroring the port's params, by ``from_reference``'s layer
    order; a factored grouped 1-D leaf's ``vr``/``vc`` in
    ``groups``). With ``mesh`` (and ``opt_cfg``), this rank's slices
    of it (module docstring)."""
    if mesh is not None:
        from repro_torch import sharding
        from repro_torch.models.model import get_model
        from repro_torch.models.steps import state_layout
        from repro_torch.training.optim import tree_map
        whole = opt_state_from_reference(cfg, ref_state, "cpu")
        ax, _ = state_layout(get_model(cfg), opt_cfg, mesh)
        return {**tree_map(lambda t, a: sharding.local_slice(
            t, a, mesh).to(device), {k: whole[k] for k in ax}, ax),
            "step": whole["step"].to(device)}
    mu = ref_state["mu"]

    def whole(leaf, path=None):
        return {k: to_torch(a, device) for k, a in leaf.items()}
    top = {k: _map_moments(v, whole) for k, v in mu.items()
           if not (k.startswith(("head_", "tail_")) or k == "blocks")}
    layers, stats = [], {}
    for key, g in _layer_order(cfg, mu):
        if g is None:
            layers.append(_map_moments(mu[key], whole))
            continue
        block = mu["blocks"][key]
        vec = _group_vectors(block)
        layers.append(_map_moments(block, lambda leaf, path, g=g, vec=vec: {
            k: to_torch(a[g], device) for k, a in leaf.items()
            if k == "m" or path not in vec}))
        stats.setdefault(key, nest(vec, lambda path, b=block: whole(
            {k: at(b, path)[k] for k in ("vr", "vc")})))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"bridged {len(layers)} layers, config has "
                         f"{cfg.num_layers}")
    out = {"mu": {**top, "layers": layers},
           "step": to_torch(np.asarray(ref_state["step"]),
                            device).reshape(())}
    groups = [stats[f"slot{s}"] for s in range(len(stats))]
    if any(groups):
        out["groups"] = groups
    return out


def opt_state_to_reference(cfg, state, like, mesh=None, opt_cfg=None):
    """Invert ``opt_state_from_reference``: the port's AdamW state -> a
    numpy tree in the reference's layout (``like``: the reference's
    state, numpy leaves). With ``mesh``, ``state`` is this rank's
    slices, gathered first (on every rank of the mesh)."""
    if mesh is not None:
        from repro_torch import sharding
        from repro_torch.models.model import get_model
        from repro_torch.models.steps import state_layout
        from repro_torch.training.optim import tree_map
        ax, shapes = state_layout(get_model(cfg), opt_cfg, mesh)
        state = {**tree_map(lambda t, a, s: sharding.gather_global(
            t, a, s.shape, mesh), {k: state[k] for k in ax}, ax, shapes),
            "step": state["step"]}
    mu, lmu = state["mu"], like["mu"]
    out = {k: _pair_moments(mu[k], lmu[k]) for k in lmu
           if not (k.startswith(("head_", "tail_")) or k == "blocks")}
    stacked: dict = {}
    for (key, g), layer in zip(_layer_order(cfg, lmu), mu["layers"]):
        if g is None:
            out[key] = _pair_moments(layer, lmu[key])
        else:
            stacked.setdefault(key, []).append(layer)
    if stacked:
        groups = state.get("groups", [])
        out["blocks"] = {}
        for s, key in enumerate(sorted(stacked, key=lambda k: int(k[4:]))):
            out["blocks"][key] = _stack_moments(
                stacked[key], lmu["blocks"][key],
                groups[s] if s < len(groups) else {})
    return {"mu": out, "step": np.asarray(state["step"].cpu().numpy())}


def _is_moment(node) -> bool:
    return isinstance(node, dict) and "m" in node and not isinstance(
        node["m"], dict)


def _map_moments(tree, fn, path=()):
    """``fn(moment dict, its path)`` on every moment dict (``{"m",
    ...}``) of a state tree."""
    if _is_moment(tree):
        return fn(tree, path)
    return {k: _map_moments(v, fn, path + (k,)) for k, v in tree.items()}


def _group_vectors(block) -> list:
    """The paths of a stacked block's grouped 1-D leaves (``vector_paths``
    of its per-layer ``m``) whose ``vr``/``vc`` are the group's: those
    of a factored state."""
    return [p for p in vector_paths(_map_moments(
        block, lambda leaf, path: leaf["m"][0])) if "vr" in at(block, p)]


def _pair_moments(tree, like):
    if _is_moment(like):
        return {k: to_numpy(tree[k], like[k]) for k in like}
    return {k: _pair_moments(tree[k], like[k]) for k in like}


def _stack_moments(layers, like, stats):
    """The reference's stacked moment dicts from the port's per-layer
    ones (``layers``) and the group's vector statistics ``stats``."""
    vec = _group_vectors(like)

    def one(leaf, path):
        out = {k: np.stack([to_numpy(at(t, path)[k], leaf[k])
                            for t in layers])
               for k in leaf if k == "m" or path not in vec}
        if path in vec:
            out.update({k: to_numpy(at(stats, path)[k])
                        for k in ("vr", "vc")})
        return out
    return _map_moments(like, one)


def _keys(tree):
    for k, v in tree.items():
        yield k
        if isinstance(v, dict):
            yield from _keys(v)


def dense_cache_from_reference(cfg, ref_cache, device="cpu"):
    """The reference's dense cache tree (numpy leaves) -> the port's
    per-layer list of ``{"k", "v"}`` or ``{"conv", "h"}`` tensors."""
    layers = from_reference(cfg, ref_cache, device)["layers"]
    return [layer["mixer"] for layer in layers]


def dense_cache_to_reference(cfg, cache, like):
    """Invert ``dense_cache_from_reference``; ``like`` is the reference's
    numpy cache tree."""
    return to_reference(cfg, {"layers": [{"mixer": c} for c in cache]},
                        like)


# ------------------------------------------------------- migration payloads

_INT_BITS = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def _payload_to_reference(cfg, arrays, like):
    """Per-leaf raw-bits arrays in the port's order -> the reference's
    leaf list for a ``like`` tree of one page or one dense row."""
    names = [sorted(_layer_of(like, key, g)) for key, g in
             _layer_order(cfg, like)]
    layers, i = [], 0
    for ns in names:
        layers.append({n: np.asarray(arrays[i + j])
                       for j, n in enumerate(ns)})
        i += len(ns)
    if i != len(arrays):
        raise ValueError(f"{len(arrays)} leaves for {i} in the reference")
    out, stacked = {}, {}
    for (key, g), layer in zip(_layer_order(cfg, like), layers):
        if g is None:
            out[key] = {"mixer": layer}
        else:
            stacked.setdefault(key, []).append({"mixer": layer})
    if stacked:
        out["blocks"] = {k: _stack(v) for k, v in stacked.items()}
    return [np.ascontiguousarray(a).view(ref.dtype).reshape(ref.shape)
            for a, ref in zip(tree_leaves(out), tree_leaves(like))]


def _layer_of(like, key, g):
    return (like[key] if g is None else like["blocks"][key])["mixer"]


def page_data_from_reference(cfg, leaves, like) -> list:
    """A reference page record's data (its pool's leaf list, (G, ps, Hkv,
    D) bf16) -> the port's raw-bits list (each layer's ``k_pages`` then
    ``v_pages``, (ps, Hkv, D) int16). ``like`` is the reference pool tree
    of one page."""
    tree = tree_unflatten(like, leaves)
    out = []
    for key, g in _layer_order(cfg, like):
        mixer = _layer_of(tree, key, g)
        for n in sorted(mixer):
            a = np.asarray(mixer[n] if g is None else mixer[n][g])
            out.append(np.ascontiguousarray(a).view(
                _INT_BITS[a.dtype.itemsize]))
    return out


def ticket_to_reference(cfg, ticket, page_like=None, dense_like=None):
    """A port ``MigrationTicket`` with its payload in the reference's form:
    every page record's data, and the dense row, as the reference's leaf
    lists. ``page_like`` is the reference pool tree of one page
    (``p[:, 0]`` of each (G, P, ...) leaf); ``dense_like`` the reference's
    one-slot dense cache tree. The other fields are unchanged."""
    pages = [dataclasses.replace(
        r, data=(None if r.data is None
                 else _payload_to_reference(cfg, r.data, page_like)))
        for r in ticket.pages]
    dense = (None if ticket.dense is None
             else _payload_to_reference(cfg, ticket.dense, dense_like))
    return dataclasses.replace(ticket, pages=pages, dense=dense)
