"""Continuous batching over the trust-tiered paged KV pool.

Port of ``repro/serving/batcher.py`` on its main path:
``PagedContinuousBatcher(prefill="chunked", fused=True)`` with greedy
sampling. Admission is **prefix-aware chunked prefill**: prompts split
into page-size chunks, chunks whose pages already live in the pool at the
request's exact trust tier are skipped, and every tick spends a bounded
``prefill_token_budget`` on queued chunks, round-robin across slots,
before decode (Sarathi-style mixed scheduling).

Each tick is a host-side PLAN (chunk resolution, page allocation, prefix
registration — no model work) and at most two device dispatches: one
batched chunk-prefill over every planned run across requests, one paged
decode whose input tokens resolve on the device (``_dev_last`` /
``_dev_gen`` hold the greedy sampling state). Dispatch shapes round up to
power-of-two buckets persisted across ticks (``_bucket``); padding is
exact-zero masked. Host arrays cross to the device through pinned buffers
without a host sync, and token values cross back only when a request
finishes (``_materialize_slot``), so the host plans tick t+1 while the
device still runs tick t.

Not ported yet: the stacked ``ContinuousBatcher``, ``fused=False``,
``prefill="full"``, stochastic sampling, page-exhaustion preemption with
resume tickets (the port raises when every decode-ready slot stalls, which
``build_island_batchers``' default ``pool_headroom=1.0`` rules out),
migration (freeze/thaw), SLO expiry, tier quotas, class-aware scheduling,
constant-shape dispatch, straggler injection, the tracer and the profiler.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.model import (attention_only, effective_pattern,
                                      get_model, resolve_device)
from repro_torch.models.steps import (make_fused_decode_step,
                                      make_fused_prefill_step)
from repro_torch.serving.kvpool import (SCRATCH_PAGE, PagePool,
                                        prefix_chunk_hashes,
                                        resolve_chunk_page)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class SlotState:
    active: bool = False
    request_id: Optional[int] = None
    pos: int = 0                # next write position (tokens so far)
    prompt_len: int = 0
    generated: list = field(default_factory=list)
    max_new: int = 16
    pages: list = field(default_factory=list)   # block list
    tier: Optional[int] = None                  # trust tier
    shared_pages: int = 0                       # prefix hits
    prompt: str = ""
    prompt_ids: list = field(default_factory=list)  # prefill token sequence
    chunks: list = field(default_factory=list)  # pending (j, hash, fill)
    next_chunk: int = 0                         # first undispatched entry
    carried: list = field(default_factory=list)  # resumed output (unused)
    # trailing generated tokens whose VALUES still live only on the device
    # (the _dev_gen buffer); the full stream is carried + generated +
    # gen_dev device-resident tokens, materialized at finish
    gen_dev: int = 0


class _BatcherBase:
    """Queue/slot lifecycle of a batcher."""

    def __init__(self, cfg, params=None, num_slots=4, max_len=256,
                 seed=0, dtype="float32", temperature=0.0, device=None):
        if temperature > 0.0:
            raise NotImplementedError(
                "stochastic sampling is not ported yet (greedy only)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = get_model(cfg)
        self.params = (params if params is not None
                       else self.model.init(seed, _DTYPES[dtype],
                                            self.device))
        self.num_slots = num_slots
        self.max_len = max_len
        self.tok = ByteTokenizer(cfg.vocab_size)
        self.slots = [SlotState() for _ in range(num_slots)]
        self.queue: list = []
        # rid -> generated text; None marks an executor-level rejection
        # (request could never fit the page pool)
        self.finished: dict[int, Optional[str]] = {}
        self._next_id = 0
        # "admissions" counts requests entering a slot; "prefill_dispatches"
        # counts logical chunk-run dispatches; "device_dispatches" counts
        # model program launches (the fused tick collapses many
        # prefill_dispatches into one); "tick_dispatches_max" is the
        # per-tick peak
        self.stats = {"ticks": 0, "prefills": 0, "admissions": 0,
                      "prefill_dispatches": 0, "decode_tokens": 0,
                      "decode_steps": 0, "queued_peak": 0,
                      "device_dispatches": 0, "tick_dispatches_max": 0}
        # virtual work clock: advances by every token the model actually
        # processes (prefill chunk fills + decode tokens)
        self.work_clock = 0
        # work_clock split by request trust tier (None = untiered)
        self.tier_work: dict = {}
        # rid -> lifecycle record (submit/admit/first-token ticks & work)
        self.request_log: dict[int, dict] = {}

    # --------------------------------------------------------- submission
    def submit(self, prompt: str, max_new_tokens=16,
               trust_tier: Optional[int] = None, slo_rank: int = 0) -> int:
        """Enqueue a request. ``trust_tier`` tags the KV pages it produces;
        None = untiered, which shares nothing (fail closed). ``slo_rank``
        is recorded only: class-aware scheduling is not ported yet."""
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, prompt, max_new_tokens, trust_tier))
        self.stats["queued_peak"] = max(self.stats["queued_peak"],
                                        len(self.queue))
        rec = {"submit_tick": self.stats["ticks"],
               "submit_work": self.work_clock,
               "tokens_skipped": 0}
        if slo_rank:
            rec["slo_rank"] = slo_rank
        self.request_log[rid] = rec
        return rid

    # ------------------------------------------------------ lifecycle notes
    def _note_admission(self, rid, prompt_tokens):
        self.stats["admissions"] += 1
        rec = self.request_log.get(rid)
        if rec is not None:
            rec["admit_tick"] = self.stats["ticks"]
            rec["prompt_tokens"] = prompt_tokens

    def _note_prefill_dispatch(self, tokens, tier=None):
        self.stats["prefills"] += 1
        self.stats["prefill_dispatches"] += 1
        self.work_clock += tokens
        self.tier_work[tier] = self.tier_work.get(tier, 0) + tokens

    def _note_decode_work(self, slot_indices):
        self.work_clock += len(slot_indices)
        for si in slot_indices:
            t = self.slots[si].tier
            self.tier_work[t] = self.tier_work.get(t, 0) + 1

    def _note_first_token(self, rid):
        rec = self.request_log.get(rid)
        if rec is not None:
            rec["first_token_tick"] = self.stats["ticks"]
            rec["ttft_ticks"] = rec["first_token_tick"] - rec["submit_tick"]
            rec["ttft_work"] = self.work_clock - rec["submit_work"]

    def _note_terminal(self, rid, outcome, tokens=0):
        """Stamp a request's terminal record: ``outcome`` is "completed"
        or "rejected" (executor-level: could never fit)."""
        rec = self.request_log.get(rid)
        if rec is not None:
            rec["done_tick"] = self.stats["ticks"]
            rec["done_work"] = self.work_clock
            rec["outcome"] = outcome
            rec["generated_tokens"] = tokens

    def busy(self) -> bool:
        return bool(self.queue) or any(s.active for s in self.slots)

    def tick(self):
        """One engine tick; ``tick_dispatches_max`` records the peak
        number of model dispatches any single tick issued."""
        d0 = self.stats["device_dispatches"]
        self._tick_inner()
        self.stats["tick_dispatches_max"] = max(
            self.stats["tick_dispatches_max"],
            self.stats["device_dispatches"] - d0)

    def run_until_done(self, max_ticks=10_000):
        while self.busy() and self.stats["ticks"] < max_ticks:
            self.tick()
        return self.finished

    def utilization(self) -> float:
        return sum(s.active for s in self.slots) / self.num_slots

    def _encode(self, prompt, max_new):
        return self.tok.encode(prompt)[: self.max_len - max_new - 1]

    def _finish_slot(self, si):
        s = self.slots[si]
        self.finished[s.request_id] = self.tok.decode(
            list(s.carried) + list(s.generated))
        self._note_terminal(s.request_id, "completed",
                            tokens=len(s.carried) + len(s.generated))
        self.slots[si] = SlotState()


class PagedContinuousBatcher(_BatcherBase):
    """Paged-pool cache manager: page-granular allocation, trust-tiered
    prefix sharing, copy-on-write appends, page free at completion, with
    budgeted chunked prefill and the fused two-dispatch tick.

    Chunk pages materialize lazily at dispatch via a late-binding re-probe
    (``kvpool.resolve_chunk_page``), so two same-tier requests admitted in
    the same tick still dedup their common head; pages a slot's
    undispatched chunks will need are counted in ``self.reserved`` and are
    off limits to decode-side alloc/COW, so prefill never stalls
    mid-flight."""

    def __init__(self, cfg, params=None, num_slots=4, max_len=256,
                 seed=0, dtype="float32", temperature=0.0, page_size=16,
                 num_pages=None, sharing=True, prefill="chunked",
                 prefill_token_budget=None, fused=True, device=None):
        if not paged_supported(cfg):
            raise ValueError(
                f"paged KV cache requires a full-history attention-only "
                f"pattern, got {sorted(set(effective_pattern(cfg)))}"
                f"{' with attn_window' if cfg.attn_window else ''}")
        if prefill != "chunked" or not fused:
            raise NotImplementedError(
                "the port carries the fused chunked-prefill path only "
                "(prefill='chunked', fused=True)")
        super().__init__(cfg, params, num_slots, max_len, seed, dtype,
                         temperature, device)
        self.page_size = page_size
        self.pages_per_seq = -(-max_len // page_size)
        if num_pages is None:
            # worst case: every slot holds a full private sequence
            num_pages = num_slots * self.pages_per_seq + 1
        self.pool = PagePool(self.model, max_len, page_size, num_pages,
                             dtype=torch.bfloat16, sharing=sharing,
                             device=self.device)
        self.block_tables = np.zeros((num_slots, self.pages_per_seq),
                                     np.int32)
        self.prefill_token_budget = (prefill_token_budget
                                     if prefill_token_budget is not None
                                     else 4 * page_size)
        # canonical dispatch width: one fused run never exceeds
        # max(budget, one chunk) tokens
        self._chunk_pages_canon = min(
            max(1, -(-self.prefill_token_budget // page_size)),
            self.pages_per_seq)
        # free pages spoken for by admitted-but-undispatched prefill chunks
        self.reserved = 0
        self._prefill_rr = 0     # rotating round-robin pointer (fairness)
        self._enc_len: dict[int, int] = {}   # backlog length memo (by rid)
        self.blocked_last_tick = 0
        self._fused_prefill = make_fused_prefill_step(self.model)
        self._fused_decode = make_fused_decode_step(self.model)
        # device-resident greedy state; row num_slots is the dump row that
        # takes the reference's mode="drop" writes (see models/steps.py)
        self._dev_last = torch.zeros((num_slots + 1,), dtype=torch.int32,
                                     device=self.device)
        self._dev_gen = torch.zeros((num_slots + 1, max_len),
                                    dtype=torch.int32, device=self.device)
        # pow2 bucket sizes used so far, per dimension (rows / chunk pages
        # / block-table widths): re-dispatching into an already-used larger
        # bucket keeps the set of launch geometries small
        self._buckets: dict[str, set] = {}
        # per-tick dispatch geometry log: ("prefill", rows, chunk_pages,
        # table_width) / ("decode", slots, table_width)
        self.dispatch_shapes: list = []
        self.stats.update({"share_hits": 0, "cow_copies": 0, "stalls": 0,
                           "preemptions": 0, "rejected_too_large": 0,
                           "prefix_tokens_skipped": 0,
                           "prefill_chunk_tokens": 0})

    # -------------------------------------------------------- fused-tick
    def _to_device(self, arr):
        """One host array onto the batcher's device. On the card the copy
        goes through a pinned staging buffer with non_blocking=True, so the
        host does not wait for the device (the caching host allocator keeps
        the buffer alive until the copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _bucket(self, kind, need, cap) -> int:
        """Dispatch-shape bucket for ``kind``: the pow2 ceiling of
        ``need`` (capped) — unless a LARGER bucket of this kind was already
        used, in which case that one is reused. Padding is numerically
        free: padded rows/pages write only the scratch page and masked
        attention positions contribute exact zeros."""
        need = max(1, min(need, cap))
        want = min(1 << (need - 1).bit_length(), cap)
        used = self._buckets.setdefault(kind, set())
        if want not in used:
            bigger = [b for b in used if b >= need]
            if bigger:
                return min(bigger)
            used.add(want)
        return want

    def _materialize_slot(self, si):
        """Pull slot ``si``'s device-resident generated tokens to the host
        (the only device sync of the fused path)."""
        s = self.slots[si]
        if not s.gen_dev:
            return
        lo = len(s.generated)
        vals = self._dev_gen[si, lo:lo + s.gen_dev].cpu().numpy()
        s.generated.extend(int(v) for v in vals)
        s.gen_dev = 0

    def _finish_slot(self, si):
        self._materialize_slot(si)
        super()._finish_slot(si)

    # ---------------------------------------------------------- admission
    def _admit(self):
        """Plan-only admission: split the prompt into page-size chunks,
        attach to every leading chunk already cached at this exact trust
        tier, and queue the rest for budgeted dispatch by
        ``_prefill_tick``. No model dispatch happens here."""
        for si, s in enumerate(self.slots):
            if s.active:
                continue
            if not self.queue:
                break
            rid, prompt, max_new, tier = self.queue[0]
            ids = self._encode(prompt, max_new)
            status = self._admit_ids(si, rid, ids, max_new, tier, prompt)
            if status == "blocked":
                # pool exhausted once other slots' pending chunks are
                # counted — leave the request queued (eviction pressure)
                self.pool.stats["blocked"] += 1
                self.blocked_last_tick += 1
                break
            self.queue.pop(0)
            self._enc_len.pop(rid, None)

    def _admit_ids(self, si, rid, ids, max_new, tier, prompt):
        """Plan-only admission of a token sequence into slot ``si``; the
        first token comes from the final chunk's boundary logits. Returns
        "ok" | "blocked" | "rejected"."""
        chunks = prefix_chunk_hashes(ids, self.page_size)
        # the admission probe's counter side effects are always rolled
        # back: every chunk is accounted exactly ONCE at resolution
        counters0 = self.pool.snapshot_share_counters()
        shared = []
        for chash, fill in chunks:
            pid = self.pool.lookup_prefix(tier, chash, fill)
            if pid is None:
                break
            shared.append(pid)
        self.pool.restore_share_counters(counters0)
        # alone-fit rejection: context plus every owed decode token must
        # fit max_len and its worst-case pages must fit the pool alone
        total = len(ids) + max_new
        if total >= self.max_len \
                or -(-total // self.page_size) > self.pool.num_pages - 1:
            self.finished[rid] = None
            self.stats["rejected_too_large"] += 1
            self._note_terminal(rid, "rejected")
            return "rejected"
        # the plan holds every chunk that must DISPATCH: fresh chunks, plus
        # the last chunk even when shared (its boundary logits are the
        # first token; it dispatches against the scratch page so the shared
        # page is never rewritten)
        plan = []
        skipped = 0
        for j, (chash, fill) in enumerate(chunks):
            if j < len(shared) and j < len(chunks) - 1:
                skipped += fill
            else:
                plan.append((j, chash, fill))
        n_fresh = sum(1 for (j, _h, _f) in plan if j >= len(shared))
        if self.pool.free_count() - self.reserved < n_fresh:
            return "blocked"
        self.pool.note_admission_attach(tier, len(shared))
        for pid in shared:
            self.pool.incref(pid)
        self.reserved += n_fresh
        row = np.zeros(self.pages_per_seq, np.int32)
        row[:len(shared)] = shared
        self.block_tables[si] = row
        self.slots[si] = SlotState(active=True, request_id=rid, pos=0,
                                   prompt_len=len(ids), max_new=max_new,
                                   pages=list(shared), tier=tier,
                                   shared_pages=len(shared), prompt=prompt,
                                   prompt_ids=list(ids), chunks=plan,
                                   next_chunk=0)
        self.stats["share_hits"] += len(shared)
        self.stats["prefix_tokens_skipped"] += skipped
        self._note_admission(rid, len(ids))
        rec = self.request_log.get(rid)
        if rec is not None:
            rec["tokens_skipped"] = rec.get("tokens_skipped", 0) + skipped
        return "ok"

    # ------------------------------------------------------ chunked prefill
    def _prefill_tick(self):
        """Sarathi-style budgeted prefill: spend up to
        ``prefill_token_budget`` prompt tokens on queued chunks, round-
        robin across slots (prefix-skipped chunks are free). The pointer
        ROTATES, so even a budget of one chunk per tick cannot starve a
        short prompt behind a long one. Every planned row fuses into ONE
        device dispatch."""
        budget = self.prefill_token_budget
        n = self.num_slots
        start = self._prefill_rr
        order = [(start + k) % n for k in range(n)]
        rows = []
        progress = True
        while budget > 0 and progress:
            progress = False
            for si in order:
                if budget <= 0:
                    break
                s = self.slots[si]
                if not (s.active and s.next_chunk < len(s.chunks)):
                    continue
                row, gtok = self._plan_prefill_row(si, budget)
                if row is not None:
                    rows.append(row)
                budget -= gtok
                self._prefill_rr = (si + 1) % n
                progress = True
        if rows:
            self._execute_prefill_rows(rows)

    def _plan_group(self, si, budget):
        """Resolve plan entries for slot ``si`` into ONE dispatch-worth of
        work: late-attached chunks are skipped for free, and CONSECUTIVE
        fresh chunks fuse into a single run of up to ``budget`` tokens (at
        least one chunk always resolves). Pure host-side planning. Returns
        (group, gtok) where group holds (chunk_idx, chash, fill, dst_page)
        entries."""
        s = self.slots[si]
        group = []                    # (chunk_idx, chash, fill, dst) run
        gtok = 0
        while s.next_chunk < len(s.chunks):
            j, chash, fill = s.chunks[s.next_chunk]
            last = s.next_chunk == len(s.chunks) - 1
            if group and (j != group[-1][0] + 1
                          or gtok + fill > max(budget, fill)):
                break                 # attach broke the run, or budget
            if len(s.pages) > j:
                dst = SCRATCH_PAGE   # admission-shared last chunk: the real
            else:                    # page already holds identical K/V
                pid, attached = resolve_chunk_page(self.pool, s.tier,
                                                   chash, fill)
                assert pid is not None, "reserved prefill page missing"
                self.reserved -= 1
                s.pages.append(pid)
                self.block_tables[si, j] = pid
                if attached:
                    s.shared_pages += 1
                    self.stats["share_hits"] += 1
                    if not last:
                        # another request finished this exact same-tier
                        # prefix chunk since admission: skip the FLOPs
                        s.next_chunk += 1
                        self.stats["prefix_tokens_skipped"] += fill
                        rec = self.request_log.get(s.request_id)
                        if rec is not None:
                            rec["tokens_skipped"] += fill
                        continue
                    dst = SCRATCH_PAGE
                else:
                    dst = pid
            group.append((j, chash, fill, dst))
            gtok += fill
            s.next_chunk += 1
            if last or gtok >= budget:
                break
        return group, gtok

    def _plan_prefill_row(self, si, budget):
        """Plan half of the fused prefill: resolve one chunk run for slot
        ``si`` and return it as a row for this tick's single dispatch.
        Fresh pages REGISTER at plan time — nothing reads a registered page
        before this tick's dispatch writes it, and a same-dispatch attach
        gathers the right bytes because every layer scatters its K/V
        before it attends. If the run completes the prompt, the boundary
        argmax token is emitted ON DEVICE into the slot's stream
        (``emit_slot``). Returns (row | None, tokens_planned)."""
        s = self.slots[si]
        group, gtok = self._plan_group(si, budget)
        if not group:
            return None, 0
        for j, chash, fill, dst in group:
            if dst != SCRATCH_PAGE:
                self.pool.register_prefix(dst, s.tier, chash, fill)
        self.stats["prefill_chunk_tokens"] += gtok
        self._note_prefill_dispatch(gtok, s.tier)
        row = {"si": si, "group": group,
               "start": group[0][0] * self.page_size,
               "bt": self.block_tables[si].copy(),
               "emit_slot": self.num_slots, "emit_off": 0, "gen_idx": 0}
        if s.next_chunk == len(s.chunks):
            s.pos = s.prompt_len
            if not s.generated and not s.gen_dev:
                row["emit_slot"] = si
                row["emit_off"] = ((s.prompt_len - 1)
                                   - group[0][0] * self.page_size)
                row["gen_idx"] = len(s.generated) + s.gen_dev
                s.gen_dev += 1
                self._note_first_token(s.request_id)
        return row, gtok

    def _execute_prefill_rows(self, rows):
        """Execute half of the fused prefill: ONE device dispatch for every
        chunk run planned this tick, across requests. Rows pad to bucketed
        shapes (row count / run pages / table width); padding rows write
        only the scratch page and emit into the dump row."""
        ps = self.page_size
        r_n = self._bucket("rows", len(rows), 1 << 16)
        c_n = self._bucket("chunk", max(len(r["group"]) for r in rows),
                           self._chunk_pages_canon)
        w_n = self._bucket("prefill_w",
                           max(r["group"][-1][0] for r in rows) + 1,
                           self.pages_per_seq)
        self.dispatch_shapes.append(("prefill", r_n, c_n, w_n))
        toks = np.zeros((r_n, c_n * ps), np.int32)
        starts = np.zeros(r_n, np.int32)
        bt = np.zeros((r_n, w_n), np.int32)
        dst = np.zeros((r_n, c_n), np.int32)               # pad -> scratch
        emit_slot = np.full(r_n, self.num_slots, np.int32)  # pad -> dump row
        emit_off = np.zeros(r_n, np.int32)
        gen_idx = np.zeros(r_n, np.int32)
        for r, row in enumerate(rows):
            s = self.slots[row["si"]]
            for n, (j, _h, fill, d) in enumerate(row["group"]):
                toks[r, n * ps:n * ps + fill] = \
                    s.prompt_ids[j * ps:j * ps + fill]
                dst[r, n] = d
            starts[r] = row["start"]
            bt[r] = row["bt"][:w_n]
            emit_slot[r] = row["emit_slot"]
            emit_off[r] = row["emit_off"]
            gen_idx[r] = row["gen_idx"]
        dev = self._to_device
        self._dev_last, self._dev_gen, self.pool.pages = \
            self._fused_prefill(
                self.params, self.pool.pages, dev(toks), dev(starts),
                dev(bt), dev(dst), dev(emit_slot), dev(emit_off),
                dev(gen_idx), self._dev_last, self._dev_gen)
        self.stats["device_dispatches"] += 1

    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens admitted or queued but not yet prefilled — the
        head-of-line signal TIDE folds into the island's queueing-latency
        term (``report_pool_pressure``)."""
        pending = sum(fill for s in self.slots if s.active
                      for (_j, _h, fill) in s.chunks[s.next_chunk:])
        queued = 0
        for rid, p, mn, _t in self.queue:
            ln = self._enc_len.get(rid)
            if ln is None:
                ln = self._enc_len[rid] = len(self._encode(p, mn))
            queued += ln
        return pending + queued

    def prefill_backlog_by_tier(self) -> dict:
        """``prefill_backlog_tokens`` split by request trust tier."""
        out: dict = {}
        for s in self.slots:
            if s.active:
                pend = sum(fill for (_j, _h, fill)
                           in s.chunks[s.next_chunk:])
                if pend:
                    out[s.tier] = out.get(s.tier, 0) + pend
        for rid, p, mn, t in self.queue:
            ln = self._enc_len.get(rid)
            if ln is None:
                ln = self._enc_len[rid] = len(self._encode(p, mn))
            out[t] = out.get(t, 0) + ln
        return out

    def tier_telemetry(self) -> dict:
        """Per-trust-tier telemetry rows for this island: pool pages and
        sharing counters, prefill backlog and work, each attributed to the
        tier of the request that caused them."""
        pool_t = self.pool.tier_telemetry()
        backlog = self.prefill_backlog_by_tier()
        out = {}
        for t in set(pool_t) | set(backlog) | set(self.tier_work):
            p = pool_t.get(t, {})
            out[t] = {"pages_in_use": p.get("pages_in_use", 0),
                      "share_hits": p.get("share_hits", 0),
                      "share_misses": p.get("share_misses", 0),
                      "prefill_backlog": backlog.get(t, 0),
                      "work": self.tier_work.get(t, 0)}
        return out

    # ------------------------------------------------------------- decode
    def _decode_alloc(self, tier):
        """Decode-side page alloc: free pages reserved for admitted-but-
        undispatched prefill chunks are off limits."""
        if self.pool.free_count() <= self.reserved:
            self.pool.stats["blocked"] += 1
            return None
        return self.pool.alloc(tier)

    def _decode_cow(self, pid, tier):
        if self.pool.free_count() <= self.reserved:
            self.pool.stats["blocked"] += 1
            return None
        return self.pool.cow(pid, tier)

    def _prepare_write_page(self, si) -> bool:
        """Make slot ``si``'s next write position backed by a private page:
        allocate on a page-boundary crossing, copy-on-write when the target
        page is shared. False = stalled (pool exhausted)."""
        s = self.slots[si]
        wp = s.pos // self.page_size
        if wp >= len(s.pages):
            pid = self._decode_alloc(s.tier)
            if pid is None:
                return False
            s.pages.append(pid)
            self.block_tables[si, wp] = pid
        pid = s.pages[wp]
        if self.pool.refcount[pid] > 1:
            new = self._decode_cow(pid, s.tier)
            if new is None:
                return False
            s.pages[wp] = new
            self.block_tables[si, wp] = new
            self.stats["cow_copies"] += 1
        return True

    # --------------------------------------------------------------- tick
    def _tick_inner(self):
        """Admit from queue (attaching to cached same-tier prefixes),
        spend the prefill token budget on queued chunks, then ONE fused
        paged decode step for every slot whose prompt is fully prefilled."""
        self.blocked_last_tick = 0
        self._admit()
        self.stats["ticks"] += 1
        self._prefill_tick()
        active = [si for si, s in enumerate(self.slots)
                  if s.active and s.next_chunk >= len(s.chunks)]
        if not active:
            return
        ready = []
        for si in active:
            if self._prepare_write_page(si):
                ready.append(si)
            else:
                self.stats["stalls"] += 1
                self.blocked_last_tick += 1
        if not ready:
            raise RuntimeError(
                f"every decode-ready slot stalled on page exhaustion "
                f"({len(active)} slots, {self.pool.free_count()} free pages, "
                f"{self.reserved} reserved): preemption with resume tickets "
                f"is not ported yet; size the pool for every slot "
                f"(pool_headroom=1.0)")
        self._decode_fused(ready)

    def _decode_fused(self, ready):
        """Fused-tick decode: one dispatch whose input tokens resolve ON
        DEVICE — a slot's last token is host-known only while
        ``gen_dev == 0`` (admission-seeded); otherwise it lives in
        ``_dev_last`` where earlier dispatches left it. Greedy next tokens
        append to the device-resident stream."""
        toks = np.zeros((self.num_slots,), np.int32)
        host_mask = np.zeros((self.num_slots,), bool)
        poss = np.zeros((self.num_slots,), np.int32)
        bt = np.zeros_like(self.block_tables)
        write_slot = np.full(self.num_slots, self.num_slots, np.int32)
        gen_idx = np.zeros((self.num_slots,), np.int32)
        for si in ready:
            s = self.slots[si]
            if s.gen_dev == 0:
                host_mask[si] = True
                toks[si] = s.generated[-1]
            poss[si] = s.pos
            bt[si] = self.block_tables[si]
            write_slot[si] = si
            gen_idx[si] = len(s.generated) + s.gen_dev
        # idle/stalled rows: host_mask stays False and their stale
        # _dev_last token decodes against the scratch page (all-zero table)
        w = self._bucket("decode_w",
                         max(self.slots[si].pos // self.page_size + 1
                             for si in ready), self.pages_per_seq)
        self.dispatch_shapes.append(("decode", self.num_slots, w))
        dev = self._to_device
        _logits, self._dev_last, self._dev_gen, self.pool.pages = \
            self._fused_decode(
                self.params, self.pool.pages, self._dev_last,
                dev(host_mask), dev(toks), dev(poss), dev(bt[:, :w]),
                dev(write_slot), dev(gen_idx), self._dev_gen)
        self.stats["device_dispatches"] += 1
        self.stats["decode_steps"] += 1
        self._note_decode_work(ready)
        for si in ready:
            s = self.slots[si]
            s.gen_dev += 1
            s.pos += 1
            self.stats["decode_tokens"] += 1
            done = (len(s.carried) + len(s.generated) + s.gen_dev
                    >= s.max_new or s.pos >= self.max_len - 1)
            if done:
                for pid in s.pages:
                    self.pool.decref(pid)
                self.block_tables[si] = 0
                self._finish_slot(si)


def paged_supported(cfg) -> bool:
    """Paged decode handles full-history attention-only patterns."""
    return attention_only(cfg) and not cfg.attn_window


def make_batcher(cfg, cache: str = "auto", **kw):
    """Factory: ``cache`` in {"auto", "paged"} — the stacked manager is not
    ported yet, so "auto" resolves to the paged pool or raises."""
    if cache == "auto":
        cache = "paged" if paged_supported(cfg) else "stacked"
    if cache == "paged":
        return PagedContinuousBatcher(cfg, **kw)
    if cache == "stacked":
        raise NotImplementedError(
            f"{cfg.name}: the stacked ContinuousBatcher is not ported yet")
    raise ValueError(f"unknown cache manager {cache!r}")
