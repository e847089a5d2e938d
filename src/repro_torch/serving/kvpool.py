"""Trust-tiered paged KV-cache pool (vLLM-style, privacy-aware).

Port of ``repro/serving/kvpool.py``. The host accounting is the
reference's, with the same semantics:

* physical storage is ``num_pages`` pages of ``page_size`` tokens each;
  a page id indexes EVERY layer's storage, so one block table serves the
  whole model;
* a free list + per-page refcounts give allocate/free at page granularity;
* pages are **copy-on-write**: a page with refcount > 1 is frozen; a writer
  must ``cow()`` it before appending, which makes prefix sharing safe;
* prefix sharing is **trust-tiered**: the prefix index is keyed by
  ``(tier, chain_hash, fill)`` — a request only attaches to a cached prefix
  page produced at exactly its own tier. Untiered requests and pools whose
  island's TIDE has crashed share nothing (fail closed).

Page 0 is reserved as a scratch page: inactive decode slots point their
block tables at it so the fused decode step can write their dummy tokens
somewhere harmless.

Device storage is one ``k_pages``/``v_pages`` pair of (num_pages,
page_size, Hkv, D) tensors per layer, built with ``torch.zeros`` (a masked
position inside a live page multiplies p = 0 by whatever V holds there,
and uninitialised memory may hold NaN bits) and updated IN PLACE: the
model's steps scatter K/V into it and ``cow`` copies a page with a slice
assignment, where the reference donated the pool to jitted ops.

Migration moves a request's pages between pools (``export_request`` /
``import_request``, with the reference's fail-closed rules). A page's
content travels as its raw bits on the host: one array per cache leaf
(``k_pages``/``v_pages`` of each layer, in depth order), bf16 viewed as
int16, so an import writes back exactly the bits that were exported.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.models.model import resolve_device
from repro_torch.serving.migration import PageRecord

SCRATCH_PAGE = 0
# the integer type whose bits carry a cache leaf of each element size
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def raw_bits(t):
    """``t`` viewed as the integer type of its element size (bf16 ->
    int16): what a migration record carries, so that no rounding can
    happen in transit."""
    return t.view(_BITS[t.element_size()])


# --------------------------------------------------------------- trust tiers

def trust_tier_for_sensitivity(s_r: float) -> int:
    """Map a MIST sensitivity score to the three-tier trust hierarchy used
    to tag KV pages (mirrors the island tiers: 1 personal, 2 private edge,
    3 cloud). High-sensitivity state may only ever be shared with requests
    in the same high tier."""
    if s_r >= 0.8:
        return 1
    if s_r >= 0.5:
        return 2
    return 3


def prefix_chunk_hashes(token_ids, page_size: int):
    """Chain hashes over page-sized chunks of a prompt.

    Returns ``[(hash, fill), ...]`` — one entry per chunk, where ``hash``
    commits to every token from position 0 through the chunk's end and
    ``fill`` is the number of tokens in the chunk (== page_size except
    possibly for the last).  Chaining means equal hash => equal *entire
    prefix*, which is the invariant that makes page sharing sound.
    """
    out = []
    h = hashlib.sha256(b"kvpool-prefix")
    for start in range(0, len(token_ids), page_size):
        chunk = token_ids[start:start + page_size]
        h.update(np.asarray(chunk, np.int32).tobytes())
        h.update(len(chunk).to_bytes(4, "little"))
        out.append((h.hexdigest(), len(chunk)))
    return out


def resolve_chunk_page(pool: "PagePool", tier: Optional[int], chash: str,
                       fill: int):
    """Late-binding prefix resolution for one planned prefill chunk:
    attach to a page registered since admission (skip the FLOPs) or take a
    fresh page. The attach path goes through ``lookup_prefix``, so every
    fail-closed rule applies identically. Returns
    ``(page_id_or_None, attached)``."""
    pid = pool.lookup_prefix(tier, chash, fill)
    if pid is not None:
        pool.incref(pid)
        return pid, True
    return pool.alloc(tier), False


# ---------------------------------------------------------------- the pool

@dataclass
class _PageMeta:
    tier: Optional[int] = None
    key: Optional[tuple] = None     # (tier, hash, fill) while indexed


class PagePool:
    """Refcounted, trust-tier-tagged fixed-page KV pool.

    ``model=None`` builds an accounting-only pool (no device tensors);
    the serving path passes the model so ``pages`` holds one
    ``{"k_pages", "v_pages"}`` dict of (num_pages, page_size, Hkv, D)
    tensors per layer on ``device`` (None = the card).
    """

    def __init__(self, model=None, max_len: int = 256, page_size: int = 16,
                 num_pages: int = 64, dtype=torch.bfloat16,
                 sharing: bool = True, device=None):
        assert num_pages >= 2, "need at least scratch + 1 usable page"
        if max_len % page_size:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of page_size "
                f"({page_size})")
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_len = max_len
        self.sharing_enabled = sharing
        self.refcount = np.zeros(num_pages, np.int32)
        self.refcount[SCRATCH_PAGE] = 1          # never allocated, never freed
        self._free = list(range(num_pages - 1, 0, -1))   # pop() -> low ids first
        self._meta = {pid: _PageMeta() for pid in range(num_pages)}
        self._prefix_index: dict[tuple, int] = {}
        self.stats = {"allocs": 0, "frees": 0, "share_hits": 0,
                      "share_misses": 0, "cow_copies": 0, "blocked": 0,
                      "peak_in_use": 0, "exported_pages": 0,
                      "imported_pages": 0, "import_attach_hits": 0,
                      "import_tier_mismatch": 0, "import_refused": 0}
        # per-trust-tier counters backing the tier-scoped telemetry view
        self.tier_stats: dict = {}
        # observability hook (wired by the owning batcher's
        # ``attach_tracer``): called as hook(kind, **attrs) on page
        # alloc / COW / prefix-share hits. Pure observation — never
        # consulted for any allocation decision.
        self.trace_hook = None
        self.pages = None
        if model is not None:
            cfg = model.cfg
            for layer in model.cache_spec(1, max_len):
                for name in layer:
                    if name not in ("k", "v"):
                        raise ValueError(
                            f"paged KV pool only supports attention "
                            f"caches, got cache leaf {name!r} (use the "
                            f"stacked batcher for ssm/rglru/mla patterns)")
            dev = resolve_device(device)
            # under a mesh, the rank's kv heads (``sharding.LOCAL_RULES``)
            shape = sharding.local_shape(
                (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim),
                (None, None, "kv_heads", None))
            self.pages = [{"k_pages": torch.zeros(shape, dtype=dtype,
                                                  device=dev),
                           "v_pages": torch.zeros(shape, dtype=dtype,
                                                  device=dev)}
                          for _ in range(cfg.num_layers)]

    # ----------------------------------------------------------- device I/O
    def write_prompt_pages(self, dense_cache, page_ids):
        """Scatter a whole admission's prompt chunks from the (1, max_len)
        dense prefill cache (``Model.init_cache``'s per-layer list) into
        the pool: chunk j of every layer lands on ``page_ids[j]``, one
        scatter per layer and tensor. Chunks past ``page_ids`` and entries
        equal to the scratch page (0) are skip markers for already-shared
        pages and positions past the prompt; several may land on the
        scratch page, whose content is never read."""
        n = self.max_len // self.page_size
        ids = np.zeros(n, np.int64)
        ids[:len(page_ids)] = page_ids
        dev = self.pages[0]["k_pages"].device
        idx = torch.from_numpy(ids).to(dev)
        for layer, dense in zip(self.pages, dense_cache):
            for name in ("k", "v"):
                pages = layer[name + "_pages"]
                pages.index_copy_(0, idx, dense[name][0].reshape(
                    n, self.page_size, *pages.shape[2:]).to(pages.dtype))

    def _leaves(self):
        """Every cache leaf, positionally: each layer's ``k_pages`` then
        ``v_pages``, in depth order (the order of a record's ``data``)."""
        return [t for layer in self.pages for t in layer.values()]

    def read_page(self, pid: int):
        """One page's K/V content as a positional list of host arrays of
        raw bits (None on accounting-only pools): the migration-export
        read."""
        return self.read_pages([pid])[0]

    def _host_slab(self, n):
        """An uninitialised host slab of the raw bits of ``n`` pages, every
        leaf: pinned when the pool is on the card, so that the copy to or
        from the device runs at the link's rate and needs no staging."""
        first = self.pages[0]["k_pages"]
        return torch.empty((2 * len(self.pages), n) + tuple(first.shape[1:]),
                           dtype=raw_bits(first).dtype,
                           pin_memory=first.device.type == "cuda")

    def read_pages(self, pids):
        """Batched ``read_page``: ONE gather per cache leaf into one device
        slab and ONE copy of it into a (pinned) host slab for the whole
        list (the per-record arrays are views of the host slab). Returns
        one leaf list per page id."""
        if not pids:
            return []
        if self.pages is None:
            return [None] * len(pids)
        leaves = self._leaves()
        first = leaves[0]
        idx = torch.as_tensor(list(pids), dtype=torch.int64).to(first.device)
        slab = torch.empty((len(leaves), len(pids)) + tuple(first.shape[1:]),
                           dtype=first.dtype, device=first.device)
        for i, leaf in enumerate(leaves):
            torch.index_select(leaf, 0, idx, out=slab[i])
        host = self._host_slab(len(pids))
        host.copy_(raw_bits(slab))
        host = host.numpy()
        return [[host[i, n] for i in range(len(leaves))]
                for n in range(len(pids))]

    def write_page(self, pid: int, data):
        """Overwrite one page from an exported record's leaf list."""
        self.write_pages([pid], [data])

    def write_pages(self, pids, datas):
        """Batched ``write_page``: the records' bits go into ONE (pinned)
        host slab, cross to the device in ONE copy, then ONE scatter per
        cache leaf writes them (``datas`` is one exported leaf list per
        page)."""
        if not pids:
            return
        assert SCRATCH_PAGE not in pids
        leaves = self._leaves()
        first = leaves[0]
        host = self._host_slab(len(pids))
        slab = host.numpy()
        for i in range(len(leaves)):
            parts = [np.asarray(d[i]) for d in datas]
            if any(p.shape != slab.shape[2:]
                   or p.dtype.itemsize != slab.dtype.itemsize
                   for p in parts):
                raise ValueError(f"page records do not fit this pool's "
                                 f"{tuple(first.shape[1:])} {first.dtype}")
            np.stack([np.ascontiguousarray(p).view(slab.dtype)
                      for p in parts], out=slab[i])
        t = host.to(first.device, non_blocking=True).view(first.dtype)
        idx = torch.as_tensor(list(pids), dtype=torch.int64).to(first.device)
        for i, leaf in enumerate(leaves):
            leaf.index_copy_(0, idx, t[i])

    # ------------------------------------------------------------ accounting
    def _tstat(self, tier) -> dict:
        d = self.tier_stats.get(tier)
        if d is None:
            d = self.tier_stats[tier] = {"allocs": 0, "share_hits": 0,
                                         "share_misses": 0}
        return d

    def snapshot_share_counters(self):
        """Share-hit/miss counters (global + per tier), for callers that
        probe ``lookup_prefix`` speculatively and must roll the counters
        back so telemetry reflects only committed sharing decisions."""
        return (self.stats["share_hits"], self.stats["share_misses"],
                {t: (d["share_hits"], d["share_misses"])
                 for t, d in self.tier_stats.items()})

    def restore_share_counters(self, snap):
        hits, misses, tiers = snap
        self.stats["share_hits"] = hits
        self.stats["share_misses"] = misses
        for t, d in self.tier_stats.items():
            h, m = tiers.get(t, (0, 0))
            d["share_hits"], d["share_misses"] = h, m

    def note_admission_attach(self, tier, n: int):
        """Count ``n`` admission-time prefix attaches."""
        if n:
            self.stats["share_hits"] += n
            self._tstat(tier)["share_hits"] += n

    def in_use_by_tier(self) -> dict:
        """Live page counts grouped by the trust tier tag on each page."""
        out: dict = {}
        for pid in range(1, self.num_pages):
            if self.refcount[pid] > 0:
                t = self._meta[pid].tier
                out[t] = out.get(t, 0) + 1
        return out

    def tier_telemetry(self) -> dict:
        """Per-trust-tier slice of the pool counters — the only pool view
        that may cross a trust boundary."""
        in_use = self.in_use_by_tier()
        out = {}
        for t in set(in_use) | set(self.tier_stats):
            s = self.tier_stats.get(t, {})
            out[t] = {"pages_in_use": in_use.get(t, 0),
                      "allocs": s.get("allocs", 0),
                      "share_hits": s.get("share_hits", 0),
                      "share_misses": s.get("share_misses", 0)}
        return out

    def in_use(self) -> int:
        """Allocated pages (excluding the reserved scratch page)."""
        return self.num_pages - 1 - len(self._free)

    def free_count(self) -> int:
        return len(self._free)

    def occupancy(self) -> float:
        return self.in_use() / max(self.num_pages - 1, 1)

    def alloc(self, tier: Optional[int] = None) -> Optional[int]:
        """Take a free page (tagged with the requester's trust tier).
        Returns None when the pool is exhausted — callers treat that as
        admission backpressure, not an error."""
        if not self._free:
            self.stats["blocked"] += 1
            return None
        pid = self._free.pop()
        assert self.refcount[pid] == 0
        self.refcount[pid] = 1
        self._meta[pid] = _PageMeta(tier=tier)
        self.stats["allocs"] += 1
        self._tstat(tier)["allocs"] += 1
        self.stats["peak_in_use"] = max(self.stats["peak_in_use"],
                                        self.in_use())
        if self.trace_hook is not None:
            self.trace_hook("page_alloc", page=pid, tier=tier,
                            in_use=self.in_use())
        return pid

    def incref(self, pid: int):
        assert pid != SCRATCH_PAGE and self.refcount[pid] > 0
        self.refcount[pid] += 1

    def decref(self, pid: int):
        assert pid != SCRATCH_PAGE, "scratch page is never freed"
        assert self.refcount[pid] > 0, f"double free of page {pid}"
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            meta = self._meta[pid]
            if meta.key is not None:
                self._prefix_index.pop(meta.key, None)
            self._meta[pid] = _PageMeta()
            self._free.append(pid)
            self.stats["frees"] += 1

    # ---------------------------------------------------------- prefix index
    def lookup_prefix(self, tier: Optional[int], chash: str,
                      fill: int) -> Optional[int]:
        """Find a live page holding this exact prefix chunk at this exact
        trust tier. Tier None (unknown sensitivity) and disabled sharing
        both fail closed: nothing is ever returned."""
        if not self.sharing_enabled or tier is None:
            return None
        pid = self._prefix_index.get((tier, chash, fill))
        if pid is None:
            self.stats["share_misses"] += 1
            self._tstat(tier)["share_misses"] += 1
            return None
        assert self._meta[pid].tier == tier      # impossible by construction
        self.stats["share_hits"] += 1
        self._tstat(tier)["share_hits"] += 1
        if self.trace_hook is not None:
            self.trace_hook("page_share", page=pid, tier=tier)
        return pid

    def register_prefix(self, pid: int, tier: Optional[int], chash: str,
                        fill: int):
        """Publish page ``pid`` as the canonical holder of a full
        prompt-prefix chunk. The fused batcher registers at PLAN time,
        which is safe because the page is written by the same tick's single
        fused dispatch and a same-dispatch attacher gathers after every
        layer's scatter."""
        if not self.sharing_enabled or tier is None:
            return
        key = (tier, chash, fill)
        if key in self._prefix_index:
            return                               # first writer wins
        self._prefix_index[key] = pid
        self._meta[pid].key = key

    def disable_sharing(self):
        """Fail closed (crashed TIDE, unattested island): stop both lookups
        and registrations. Existing shared pages stay refcounted/safe."""
        self.sharing_enabled = False

    # ------------------------------------------------------------------ COW
    def cow(self, pid: int, tier: Optional[int] = None) -> Optional[int]:
        """Copy-on-write: take a private copy of ``pid`` for a writer.
        Decrefs the original, returns the new page id (None if the pool is
        exhausted; the caller must then stall the writer)."""
        new = self.alloc(tier if tier is not None else self._meta[pid].tier)
        if new is None:
            return None
        if self.pages is not None:
            for layer in self.pages:
                for t in layer.values():
                    t[new] = t[pid]
        self.decref(pid)
        self.stats["cow_copies"] += 1
        if self.trace_hook is not None:
            self.trace_hook("page_cow", page=pid, new_page=new)
        return new

    # ------------------------------------------------------------ telemetry
    def telemetry(self) -> dict:
        return {
            "num_pages": self.num_pages - 1,
            "in_use": self.in_use(),
            "occupancy": round(self.occupancy(), 4),
            "peak_in_use": self.stats["peak_in_use"],
            "share_hits": self.stats["share_hits"],
            "share_misses": self.stats["share_misses"],
            "share_hit_rate": round(
                self.stats["share_hits"]
                / max(self.stats["share_hits"] + self.stats["share_misses"],
                      1), 4),
            "cow_copies": self.stats["cow_copies"],
            "blocked": self.stats["blocked"],
            "sharing_enabled": self.sharing_enabled,
            "exported_pages": self.stats["exported_pages"],
            "imported_pages": self.stats["imported_pages"],
            "import_attach_hits": self.stats["import_attach_hits"],
            "import_tier_mismatch": self.stats["import_tier_mismatch"],
        }

    # ------------------------------------------------------------ invariants
    def audit(self):
        """Full invariant sweep (the property tests' oracle): free list
        without duplicates or live pages, refcount conservation (live pages
        == allocs - frees), the scratch page pinned, and the prefix index
        and page metadata agreeing both ways with matching tiers."""
        assert len(set(self._free)) == len(self._free), "free list dup"
        for pid in self._free:
            assert self.refcount[pid] == 0, f"free page {pid} has refs"
            meta = self._meta[pid]
            assert meta.tier is None and meta.key is None, \
                f"free page {pid} kept metadata"
        live = self.in_use()
        assert live == sum(1 for p in range(1, self.num_pages)
                           if self.refcount[p] > 0)
        assert live == self.stats["allocs"] - self.stats["frees"], \
            "refcount conservation broken (leak or double free)"
        assert self.refcount[SCRATCH_PAGE] == 1, "scratch page unpinned"
        for key, pid in self._prefix_index.items():
            assert self.refcount[pid] > 0, "index points at freed page"
            assert self._meta[pid].key == key, "index/meta disagree"
            assert self._meta[pid].tier == key[0], "cross-tier index entry"
        for pid, meta in self._meta.items():
            if meta.key is not None:
                assert self._prefix_index.get(meta.key) == pid, \
                    f"page {pid} claims an index key it doesn't hold"
        return True

    def check(self):
        """Back-compat alias for :meth:`audit`."""
        return self.audit()


# ----------------------------------------------------- migration (export)

def export_request(pool: PagePool, page_ids, kv_tokens: int):
    """Serialize one request's live pages for cross-island migration.

    Returns one ``PageRecord`` per page, in block-table order: the page's
    trust tier, its prefix-index key when it holds a registered full
    prompt-prefix chunk (so the destination can re-attach by chain hash
    instead of copying bytes), its fill within the request's ``kv_tokens``
    context, and the page content (None on accounting-only pools). Every
    page is decrefed afterwards: the request has LEFT this pool; shared
    pages survive under their other referents.
    """
    ps = pool.page_size
    datas = pool.read_pages(list(page_ids))
    records = []
    for n, pid in enumerate(page_ids):
        meta = pool._meta[pid]
        fill = max(0, min(ps, kv_tokens - n * ps))
        records.append(PageRecord(tier=meta.tier, key=meta.key, fill=fill,
                                  data=datas[n]))
    for pid in page_ids:
        pool.decref(pid)
    pool.stats["exported_pages"] += len(records)
    return records


def import_request(pool: PagePool, records, tier: Optional[int]):
    """Materialize exported pages in this pool, all-or-nothing.

    Per record: a prefix-keyed page whose fill equals its key's first
    probes the destination's OWN prefix index through the tier-keyed
    ``lookup_prefix`` — a hit re-attaches (increfed, zero bytes shipped).
    Everything else deep-copies into a freshly allocated page tagged with
    the record's tier and, when keyed, registers in the index strictly
    AFTER its bytes are written.

    Fail-closed rules, enforced here so no caller can launder trust:
    untiered requests never import; a record whose tier differs from the
    request's refuses the WHOLE import; a pool that stores real K/V
    refuses records without data; exhaustion mid-import rolls everything
    back. Returns ``(page_ids, copied, attach_hits)`` or None (the caller
    recomputes from tokens).
    """
    if tier is None:
        pool.stats["import_refused"] += 1
        return None
    for rec in records:
        if rec.tier != tier:
            pool.stats["import_tier_mismatch"] += 1
            pool.stats["import_refused"] += 1
            return None
    counters0 = pool.snapshot_share_counters()
    got: list[tuple[int, bool]] = []
    copies: list[tuple[int, PageRecord]] = []

    def rollback():
        for pid, _ in got:
            pool.decref(pid)
        pool.restore_share_counters(counters0)
        pool.stats["import_refused"] += 1
        return None

    for rec in records:
        # re-attach only when the page holds EXACTLY the registered chunk:
        # a tail page the source kept appending decode tokens to carries
        # content past the key's fill that the hash does not commit to
        if rec.key is not None and rec.fill == rec.key[2]:
            hit = pool.lookup_prefix(*rec.key)
            if hit is not None:
                pool.incref(hit)
                got.append((hit, True))
                continue
        if pool.pages is not None and rec.data is None:
            return rollback()        # no bytes to materialize
        pid = pool.alloc(rec.tier)
        if pid is None:
            return rollback()        # exhausted: caller recomputes
        got.append((pid, False))
        copies.append((pid, rec))
    # the whole import is decided: write every copied page, then register
    # (a hit must always be readable)
    if pool.pages is not None and copies:
        pool.write_pages([pid for pid, _ in copies],
                         [rec.data for _, rec in copies])
    for pid, rec in copies:
        if rec.key is not None:
            pool.register_prefix(pid, *rec.key)
    attach_hits = sum(1 for _, a in got if a)
    copied = len(copies)
    pool.stats["imported_pages"] += copied
    pool.stats["import_attach_hits"] += attach_hits
    return [pid for pid, _ in got], copied, attach_hits
