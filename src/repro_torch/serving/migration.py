"""Live cross-island request migration: the wire format.

A ``MigrationTicket`` is everything needed to continue a frozen in-flight
request on another island, bit-exactly: the (possibly sanitized) prompt
and its token ids, every token generated so far, the per-request sampling
state, and the request's KV state as a list of ``PageRecord``s (paged
batchers) or a dense cache row (stacked batchers).

Trust is carried, never laundered: each exported page keeps the trust tier
it was produced at, and a page registered in the source's prefix index
also travels with its ``(tier, chain_hash, fill)`` key so the destination
can RE-ATTACH to its own same-tier prefix page instead of copying data —
the hash commits to the entire prefix, so a hit means the destination
already holds identical K/V. Everything else deep-copies into freshly
allocated, same-tier-tagged pages. Cross-tier physical reuse stays
impossible by construction because the re-attach path is the pool's own
tier-keyed ``lookup_prefix``.

Stripping a ticket (``without_pages``) is the fail-closed direction: a
destination whose tier may not receive raw KV gets a recompute-from-tokens
ticket instead of the payload. When re-routing changes the query text
(different sanitization boundary) the engine drops the ticket entirely and
resubmits the new text from scratch — nothing computed for the old text is
reusable.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass
class PageRecord:
    """One exported KV page. ``key`` is the source prefix-index key
    ``(tier, chain_hash, fill)`` when the page held a registered full
    prompt-prefix chunk (re-attachable by hash at the destination), None
    for private tail/decode pages. ``data`` is the page's K/V content as a
    positional list of host arrays, one per cache leaf — None when the
    source pool is accounting-only."""
    tier: Optional[int]
    key: Optional[tuple]
    fill: int
    data: Optional[list] = None


@dataclass
class MigrationTicket:
    """A frozen in-flight request, ready to thaw on another island."""
    rid: int                       # source-batcher request id (telemetry)
    prompt: str                    # query text as served (post-sanitize)
    prompt_ids: list               # encoded prompt tokens
    generated: list                # tokens generated so far
    max_new: int
    tier: Optional[int]            # trust tier of the request's KV pages
    kv_tokens: int = 0             # context tokens the exported KV covers
    page_size: int = 0             # source pool page size (0 = no pages)
    pages: list = field(default_factory=list)      # list[PageRecord]
    dense: Optional[list] = None   # stacked-mode cache row (leaf list)
    max_len: int = 0               # stacked-mode row capacity
    sample_key: Optional[object] = None            # per-slot PRNG state
    phase: str = "queued"          # "queued" | "prefill" | "decode"
    source: str = ""               # island the request left (telemetry)
    log: Optional[dict] = None     # request_log record carried across

    def context_ids(self) -> list:
        """Token ids whose K/V a resumed request must hold before its next
        decode step: the prompt plus every generated token except the last
        (which has been sampled but not yet fed through the model). With
        nothing generated, just the prompt."""
        if self.generated:
            return list(self.prompt_ids) + list(self.generated[:-1])
        return list(self.prompt_ids)

    def progress(self) -> tuple:
        """``(carried, pending)``: every generated token except the last
        is recompute context (it is inside ``context_ids()``), while the
        last has been sampled but not yet fed through the model and rides
        the resumed slot's ``generated`` list. Single source of the
        off-by-one every thaw path depends on for bit-exactness."""
        return list(self.generated[:-1]), list(self.generated[-1:])

    def owed(self) -> int:
        """Decode tokens this request is still owed."""
        return max(self.max_new - len(self.generated), 0)

    def resumes_compute(self) -> bool:
        """True when the source had computed anything for this request —
        generated tokens, KV pages, or a dense row. Thawing such a ticket
        without its payload genuinely REDOES work (a recompute, for
        telemetry); thawing a still-queued ticket is just a first
        admission somewhere else."""
        return bool(self.generated or self.pages or self.dense is not None)

    def without_pages(self) -> "MigrationTicket":
        """Drop the KV payload (page records / dense row): the destination
        recomputes the context from tokens. Used when the destination's
        tier may not receive raw pages — generation progress survives, the
        KV bytes do not."""
        return replace(self, pages=[], dense=None, kv_tokens=0,
                       page_size=0, max_len=0)


def ticket_fits(ticket: MigrationTicket, max_len: int,
                page_size: Optional[int] = None,
                num_pages: Optional[int] = None) -> bool:
    """Destination-geometry check shared by the engine's placement pass
    and the batchers' thaw admission — the two MUST agree, or a request
    the engine dispatched gets rejected (dropped) at the batcher instead
    of bounced back to its source. Mirrors the guarantee fresh admission
    gets from ``_encode``'s truncation: the resumed context plus every
    still-owed decode token must fit ``max_len`` (otherwise the decode
    loop's ``pos >= max_len - 1`` stop silently truncates the stream),
    and on paged pools the worst-case page count must fit alone."""
    total = len(ticket.context_ids()) + ticket.owed()
    if total >= max_len:
        return False
    if page_size and num_pages:
        if -(-total // page_size) > num_pages - 1:
            return False
    return True
