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

Not ported yet: the migration export/import of pages.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.models.model import resolve_device

SCRATCH_PAGE = 0


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
        self.pages = None
        if model is not None:
            cfg = model.cfg
            dev = resolve_device(device)
            shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
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
