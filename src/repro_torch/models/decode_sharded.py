"""Sequence-sharded decode attention (flash-decoding over ranks).

Port of ``repro/models/decode_sharded.py``. When a model's kv_heads do not
divide the mesh's model axis (GQA kv=1/2/3/8 on a 16-way axis, or MLA's
headless latent cache), replicating the KV cache on every rank is
hopeless at 32k-524k contexts. Instead the cache's *sequence* dim is
sharded over the model axis: rank ``r`` of ``n`` holds global slots
``[r * S_loc, (r + 1) * S_loc)`` of a cache of ``S = n * S_loc`` slots
(``Model.init_cache`` under the mesh allocates only those, as a
``SeqSplitCache``), and decode attention runs per rank, as the
reference's ``shard_map`` body ``_inner``:

  - the rank owning slot ``pos`` writes the new K/V (a one-slot predicated
    write: every rank writes, the others their slot's old value back)
  - every rank computes partial scores over its local slots, masked at
    the finite ``NEG_INF`` past the fill
  - partials merge with a log-sum-exp combine: an all-reduce MAX of the
    row maxima ``m``, an all-reduce SUM of the denominators ``l`` (then
    floored at 1e-30) and one of the weighted values

over the mesh's "model" process group. Where the model axis does not
divide the slots (``use_seq_sharded``'s ``seq_len``), the reference keeps
the cache whole and decodes it unsharded, and so does the port: the
layer's cache is then a plain dict. Three all-reduces a layer: two
(B, Hkv, G) and one (B, Hkv, G, Dv), O(B H D) bytes instead of an O(S)
gather. The arithmetic is plain fp32 torch ops, as the reference computes
it with ``einsum`` outside any Pallas kernel. ``pos`` is a scalar or (B,)
per-row positions (the reference's step takes a scalar).

``seq_sharded_decode.calls`` and ``.all_reduces`` count its calls and
collectives, as the kernel wrappers count ``.launches``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree

from repro_torch.sharding import current_mesh, mesh_shape

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def use_seq_sharded(kv_heads: int, seq_len: int | None = None) -> bool:
    mesh = current_mesh()
    if mesh is None:
        return False
    sizes = mesh_shape(mesh)
    if sizes.get("model", 1) == 1:
        return False
    if seq_len is not None and seq_len % sizes["model"] != 0:
        return False  # cache too short/ragged to seq-shard
    return kv_heads == 0 or kv_heads % sizes["model"] != 0


def seq_shard_axes():
    """Logical axes for a seq-sharded KV cache entry (B,S,Hkv,D)."""
    return ("batch", "kv_seq", None, None)


class SeqSplitCache(dict):
    """One layer's dense cache whose slots are split over "model": each
    rank holds its range of ``n * S_loc`` global slots. ``Model.init_cache``
    makes one for a layer whose ``cache_spec`` names "kv_seq" (the
    reference's ``use_seq_sharded`` of its kv heads and its global slot
    count) under a model axis of more than one rank; every other dense
    cache, a plain dict, is whole on each rank (its kv heads' share), as
    where the model axis does not divide the slots the reference keeps
    the cache whole and decodes it unsharded. Attention and MLA read
    this flag, not the local slot count, which cannot tell 37 whole slots
    from 74 split over two ranks. Code that rebuilds a layer's dict keeps
    its type (``type(layer)(...)``)."""


# a node of torch's pytrees as a dict is, so that walks over a cache (the
# dry-run's byte counts) see its tensors
_pytree.register_pytree_node(
    SeqSplitCache, lambda c: (list(c.values()), list(c.keys())),
    lambda values, keys: SeqSplitCache(zip(keys, values)),
    serialized_type_name=f"{__name__}.SeqSplitCache")


def check_whole(kv_heads: int, slots: int):
    """Refuse a plain-dict cache of ``slots`` slots a rank that the
    current mesh would have split over "model": it was not made by
    ``Model.init_cache``, and its global length is unknown."""
    if use_seq_sharded(kv_heads, slots):
        raise ValueError(
            f"a dense cache of {slots} slots a rank under this mesh is "
            f"split over 'model' (Model.init_cache makes it a "
            f"decode_sharded.SeqSplitCache); this one is a plain dict")


def model_shards():
    """(this rank's index along "model", the model axis's ranks)."""
    mesh = current_mesh()
    return mesh.get_local_rank("model"), mesh_shape(mesh)["model"]


def _all_reduce(t, op, group):
    dist.all_reduce(t, op=op, group=group)
    seq_sharded_decode.all_reduces += 1
    return t


def write_owned(leaf, new, slot, rank):
    """The predicated one-slot write into this rank's slots ``leaf`` (B,
    S_loc, ...): row b's ``new[b]`` lands on global slot ``slot[b]`` where
    this rank owns it; elsewhere the slot's old value is written back."""
    B, S_loc = leaf.shape[:2]
    rows = torch.arange(B, device=leaf.device)
    lp = slot - rank * S_loc
    own = ((lp >= 0) & (lp < S_loc)).view((B,) + (1,) * (leaf.dim() - 2))
    lpc = torch.clamp(lp, 0, S_loc - 1)
    new = new.to(leaf.dtype)
    if leaf.element_size() == 1:     # fp8 has no where(): blend the bits
        leaf, new = leaf.view(torch.uint8), new.view(torch.uint8)
    leaf[rows, lpc] = torch.where(own, new, leaf[rows, lpc])


def _inner(kc, vc, kn, vn, q, slot, valid, *, scale, rank, group):
    """One rank's part: ``kc``/``vc`` its local slots (B, S_loc, Hkv,
    Dk/Dv), written in place; ``slot``/``valid`` (B,) global slot and
    fill. Returns the merged output (B, 1, H, Dv) in q's dtype."""
    B, S_loc, Hkv, Dk = kc.shape
    Dv = vc.shape[-1]
    H = q.shape[2]
    G = H // Hkv
    write_owned(kc, kn[:, 0], slot, rank)
    write_owned(vc, vn[:, 0], slot, rank)

    qg = q.reshape(B, Hkv, G, Dk).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kc.float()) * scale
    gslot = rank * S_loc + torch.arange(S_loc, device=kc.device)
    live = (gslot[None, :] < valid[:, None])[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = _all_reduce(s.amax(dim=-1), dist.ReduceOp.MAX, group)
    p = torch.exp(s - m[..., None])
    l = _all_reduce(p.sum(dim=-1), dist.ReduceOp.SUM, group)
    num = _all_reduce(torch.einsum("bhgk,bkhd->bhgd", p, vc.float()),
                      dist.ReduceOp.SUM, group)
    o = (num / torch.clamp(l, min=1e-30)[..., None]).reshape(B, 1, H, Dv)
    return o.to(q.dtype)


def slot_and_fill(pos, B, W, window, device):
    """(slot, valid) (B,) int64 of a decode at ``pos`` (scalar or (B,))
    into a cache of W global slots: a ring writes ``pos % W``, a plain
    cache ``min(pos, W - 1)``; the fill is ``min(pos + 1, W)``."""
    posb = (torch.zeros(B, dtype=torch.int64, device=device)
            + torch.as_tensor(pos, device=device).long())
    slot = posb % W if window else torch.clamp(posb, max=W - 1)
    return slot, torch.clamp(posb + 1, max=W)


def seq_sharded_decode(k_cache, v_cache, k_new, v_new, q, pos, window,
                       scale):
    """k_cache/v_cache: this rank's local slots (B, S_loc, Hkv, Dk/Dv) of
    a cache whose sequence dim is sharded over "model", updated in place;
    k_new/v_new (B, 1, Hkv, D*); q (B, 1, H, Dk); pos a scalar or (B,).
    Returns (k_cache, v_cache, out (B, 1, H, Dv))."""
    seq_sharded_decode.calls += 1
    mesh = current_mesh()
    n = mesh_shape(mesh)["model"]
    rank = mesh.get_local_rank("model")
    B, S_loc = k_cache.shape[0], k_cache.shape[1]
    slot, valid = slot_and_fill(pos, B, S_loc * n, window, k_cache.device)
    o = _inner(k_cache, v_cache, k_new, v_new, q, slot, valid, scale=scale,
               rank=rank, group=mesh.get_group("model"))
    return k_cache, v_cache, o


seq_sharded_decode.calls = 0
seq_sharded_decode.all_reduces = 0


def gather_seq(x, group, rank, n):
    """The global (B, n * S_loc, ...) tensor on every rank from each
    rank's (B, S_loc, ...) slots: an all-reduce SUM of a zero-filled
    buffer (gloo on CUDA tensors has no all-gather)."""
    S_loc = x.shape[1]
    out = torch.zeros((x.shape[0], S_loc * n) + tuple(x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    out[:, rank * S_loc:(rank + 1) * S_loc] = x
    dist.all_reduce(out, group=group)
    return out


def write_prompt(cache_leaf, val, rank, n):
    """A full prefill's write into this rank's slots of a seq-sharded
    leaf: ``val`` (B, S, ...) are the prompt's values in the order the
    global cache takes them (slot j <- token j, or, for a ring of W < S
    slots, token S - W + j), of which the rank keeps
    ``[rank * S_loc, (rank + 1) * S_loc)``."""
    S_loc = cache_leaf.shape[1]
    W, S = S_loc * n, val.shape[1]
    lo = rank * S_loc
    if W >= S:
        hi = min(S, lo + S_loc)
        if hi > lo:
            cache_leaf[:, :hi - lo] = val[:, lo:hi].to(cache_leaf.dtype)
    else:                          # ring: the last W tokens
        cache_leaf.copy_(val[:, S - W + lo:S - W + lo + S_loc])
