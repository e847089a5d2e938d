"""Continuous batching schedulers for a SHORE island.

Port of ``repro/serving/batcher.py``. Two cache managers behind one
interface (``make_batcher(cfg, cache=...)``):

* ``ContinuousBatcher`` (``cache="stacked"``): fixed decode slots over one
  dense KV cache per layer with a leading (num_slots,) axis. Admission
  prefills one request into a (1, max_len) cache and writes the whole row
  into its slot; each tick runs ONE decode dispatch over every slot,
  inactive ones included (they decode a dummy token at position 0 of their
  row), as the reference's ``jax.vmap`` does. Attention goes through
  ``flash_attention`` (prefill) and ``decode_attention`` (decode). An SSM
  layer's row is its ``{"conv", "h"}`` state (bf16 conv tail, fp32 SSM
  state), prefilled through ``ssd_chunk`` (K5) and decoded as the O(1)
  state update; mamba2 serves only through this manager.
* ``PagedContinuousBatcher`` (``cache="paged"``): the trust-tiered paged
  KV pool (``serving.kvpool``). Admission is **prefix-aware chunked
  prefill** by default: prompts split into page-size chunks, chunks whose
  pages already live in the pool at the request's exact trust tier are
  skipped, and every tick spends a bounded ``prefill_token_budget`` on
  queued chunks, round-robin across slots, before decode (Sarathi-style
  mixed scheduling). ``prefill="full"`` keeps the monolithic
  one-dispatch-per-admission prefill (``flash_attention`` into a dense
  row, scattered into the pool) as the A/B baseline.

The chunked path runs **fused** by default: each tick is a host-side PLAN
(chunk resolution, page allocation, prefix registration — no model work)
and at most two device dispatches: one batched chunk-prefill over every
planned run across requests, one paged decode whose input tokens resolve
on the device (``_dev_last`` / ``_dev_gen`` hold the greedy sampling
state; at ``temperature > 0`` the decode logits come back and each ready
slot samples on the host side of the tick, as the reference does). Dispatch shapes round up to power-of-two buckets persisted across
ticks (``_bucket``); padding is exact-zero masked. Host arrays cross to
the device through pinned buffers without a host sync, and token values
cross back only when a request finishes or is preempted
(``_materialize_slot``), so the host plans tick t+1 while the device still
runs tick t. ``fused=False`` dispatches every chunk run on its own and
samples each decode step on the host: the launch-count baseline, with the
same token streams.

Sampling is greedy at ``temperature`` 0 and stochastic above it
(``serving.sampling``): each slot carries its own key (``sample_key``,
``(stream seed, draws so far)``), set at admission from the batcher's seed
and an admission counter and advanced once per draw, and one dispatch
samples every ready row. A request's first token is the argmax of its
prompt's last logits whatever the temperature, as in the reference
(ROADMAP R7).

When every decode-ready slot stalls on an exhausted pool, the
least-invested slot is **preempted**: its pages return to the pool and it
requeues at the head with a resume ticket (``serving.migration``) that
keeps its generated tokens, so re-admission recomputes its context and
its stream continues where it stopped.

Both managers support **live migration** (freeze/thaw):
``freeze_request`` evacuates a request (still queued, mid-prefill or
mid-decode) into a ``MigrationTicket`` with its KV pages or dense cache
row, its generation progress and its sampling key, and ``submit_ticket``
thaws a ticket through the normal admission queue on the destination: a
page import (prefix-keyed pages re-attach to same-tier chain-hash matches,
the rest deep-copy) or a dense-row import when the payload is legal and
fits, recompute of the context otherwise. Either way the resumed stream is
the one the source would have produced.

Observation and degradation (ROADMAP Queue 1, P9): ``attach_tracer``
journals every lifecycle step (queue, admit, prefill, first token,
decode, preempt, freeze, finish, expire, page alloc/share/COW) on the
batcher's tick and work clocks, a ``DispatchProfiler`` (``profiler``)
splits each tick into host planning, bucketing, dispatch submission and
device waits; neither reads the device or changes a decision.
``cancel_request`` ends a request at any stage (SLO expiry: a fused
slot's device-resident tail is dropped unread), ``set_slowdown`` makes
the batcher a straggler, and ``class_aware`` batchers prefer the highest
SLO rank in admission, chunk order and preemption.

Privacy hardening (ROADMAP Queue 1, P10), both opt-in on the paged
batcher: ``constant_shape`` pins every dispatch bucket to its per-kind
maximum (rows ``num_slots``, the canonical chunk width, table width
``pages_per_seq``), so launch geometry (and with it each attention
kernel's key-walk split) carries nothing about which requests were
served; ``tier_quotas`` gives each listed trust tier a hard slot cap and
a fixed share of the prefill budget, so one tier's admission latency and
prefill pace do not depend on another's load. ``make_batcher`` drops both
for the stacked manager, as the reference does.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.model import (effective_pattern, get_model,
                                      resolve_device)
from repro_torch.models.steps import (make_chunked_prefill_step,
                                      make_fused_decode_step,
                                      make_fused_prefill_step,
                                      make_paged_serve_step,
                                      make_prefill_step, make_serve_step)
from repro_torch.serving.kvpool import (SCRATCH_PAGE, PagePool,
                                        export_request, import_request,
                                        prefix_chunk_hashes, raw_bits,
                                        resolve_chunk_page)
from repro_torch.serving.migration import MigrationTicket, ticket_fits
from repro_torch.serving.sampling import sample, stream_key

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
    # resumed requests (preemption re-admission): output tokens folded
    # into prompt_ids as recompute context — the full output stream is
    # carried + generated
    carried: list = field(default_factory=list)
    # per-request sampling key (stream seed, draws so far)
    sample_key: Optional[tuple] = None
    # trailing generated tokens whose VALUES still live only on the device
    # (the _dev_gen buffer); the full stream is carried + generated +
    # gen_dev device-resident tokens, materialized at finish, freeze and
    # preemption
    gen_dev: int = 0


class _BatcherBase:
    """Queue/slot lifecycle shared by both cache managers."""

    def __init__(self, cfg, params=None, num_slots=4, max_len=256,
                 seed=0, dtype="float32", temperature=0.0, device=None,
                 class_aware=False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = get_model(cfg)
        self.params = (params if params is not None
                       else self.model.init(seed, _DTYPES[dtype],
                                            self.device))
        self.num_slots = num_slots
        self.max_len = max_len
        self.temperature = temperature
        # SLO-class-aware scheduling (opt-in): admission and budgeted
        # prefill prefer the highest ``slo_rank`` (FCFS within a rank),
        # and page-exhaustion preemption prefers low-rank victims. False
        # keeps every scheduling decision identical to the unranked path.
        self.class_aware = class_aware
        self.tok = ByteTokenizer(cfg.vocab_size)
        # sampling keys: admission n of this batcher draws from stream
        # stream_key(seed + 1, n)
        self._key_seed = seed + 1
        self._keys_issued = 0
        self.slots = [SlotState() for _ in range(num_slots)]
        self.queue: list = []
        # rid -> generated text; None marks an executor-level rejection
        # (request could never fit the page pool)
        self.finished: dict[int, Optional[str]] = {}
        self._next_id = 0
        # rid -> MigrationTicket of a queued thaw or a preempted request
        # (entries ride the normal queue; admission resolves them)
        self._tickets: dict[int, MigrationTicket] = {}
        self.migration_stats = {"exports": 0, "imports": 0,
                                "imported_pages": 0, "import_attach_hits": 0,
                                "recomputes": 0}
        self.preempted_rids: list = []
        self._prefill = make_prefill_step(self.model)
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
        # observability (opt-in, zero-interference): a Tracer receives
        # span events stamped on this batcher's tick/work clocks, a
        # DispatchProfiler times tick phases. Both default off; neither
        # may touch scheduling state, and no event attribute is read
        # from the device
        self.tracer = None
        self.island = ""
        self.profiler = None
        # fault injection: work-clock multiplier (1 = full speed); a
        # slowed batcher does real work only every ``slowdown``-th tick
        self.slowdown = 1
        self._slow_phase = 0

    def attach_tracer(self, tracer, island: str = ""):
        """Attach a span tracer; ``island`` labels this batcher's events.
        Paged mode also wires the page pool's event hook."""
        self.tracer = tracer
        self.island = island
        pool = getattr(self, "pool", None)
        if pool is not None and tracer is not None:
            pool.trace_hook = self._trace

    def _trace(self, kind, rid=None, **attrs):
        if self.tracer is not None:
            self.tracer.emit(kind, island=self.island, rid=rid,
                             tick=self.stats["ticks"],
                             work=self.work_clock, **attrs)

    @contextmanager
    def _dispatching(self):
        """Charge a model dispatch (staging its host arrays and issuing
        its launches) to the profiler's ``dispatch_submit``."""
        prof = self.profiler
        if prof is None:
            yield
            return
        with prof.phase("dispatch_submit"):
            yield
        prof.add_ns("dispatch_submit", 0, dispatches=1)

    def _readback(self, t):
        """``t`` on the host as a numpy array. The copy waits for the
        device, so a profiler charges it to ``device_sync``."""
        if self.profiler is None:
            return t.cpu().numpy()
        with self.profiler.phase("device_sync"):
            return t.cpu().numpy()

    # --------------------------------------------------------- submission
    def submit(self, prompt: str, max_new_tokens=16,
               trust_tier: Optional[int] = None, slo_rank: int = 0) -> int:
        """Enqueue a request. ``trust_tier`` tags the KV pages it produces
        (paged mode); None = untiered, which shares nothing (fail closed).
        The stacked cache manager ignores the tier. ``slo_rank`` is the
        request's SLO-class urgency (higher = tighter TTFT target; 0 =
        unclassed/batch), inert unless ``class_aware`` is set."""
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, prompt, max_new_tokens, trust_tier))
        self.stats["queued_peak"] = max(self.stats["queued_peak"],
                                        len(self.queue))
        rec = {"submit_tick": self.stats["ticks"],
               "submit_work": self.work_clock,
               "tokens_skipped": 0}
        if slo_rank:
            rec["slo_rank"] = slo_rank  # carries across migrations (log)
        self.request_log[rid] = rec
        if self.tracer is not None:
            self._trace("queue", rid=rid, tier=trust_tier,
                        max_new=max_new_tokens)
        return rid

    def submit_ticket(self, ticket: MigrationTicket) -> int:
        """Enqueue a frozen in-flight request for thawing here. The ticket
        rides the normal admission queue (same ordering, same
        backpressure); admission either imports its KV payload or
        recomputes the context from tokens. Returns this batcher's rid."""
        rid = self._next_id
        self._next_id += 1
        self._tickets[rid] = ticket
        self.queue.append((rid, ticket.prompt, ticket.max_new, ticket.tier))
        self.stats["queued_peak"] = max(self.stats["queued_peak"],
                                        len(self.queue))
        enc_len = getattr(self, "_enc_len", None)
        if enc_len is not None:
            # the thaw prefills the whole resumed context, not just the
            # prompt: report the real backlog
            enc_len[rid] = len(ticket.context_ids())
        rec = dict(ticket.log) if ticket.log else {}
        rec.setdefault("tokens_skipped", 0)
        # clock-relative fields re-stamp on this batcher's clocks;
        # cumulative fields (tokens_skipped, migrations, a recorded TTFT)
        # carry
        rec["submit_tick"] = self.stats["ticks"]
        rec["submit_work"] = self.work_clock
        rec["migrations"] = rec.get("migrations", 0) + 1
        self.request_log[rid] = rec
        if self.tracer is not None:
            self._trace("thaw_queue", rid=rid, tier=ticket.tier,
                        phase=ticket.phase, kv_tokens=ticket.kv_tokens)
        return rid

    # --------------------------------------------- class-aware scheduling
    def _rank_of(self, rid: int) -> int:
        rec = self.request_log.get(rid)
        return rec.get("slo_rank", 0) if rec else 0

    def _slot_rank(self, si: int) -> int:
        s = self.slots[si]
        return self._rank_of(s.request_id) if s.active else 0

    def _queue_pick(self, admissible=None) -> Optional[int]:
        """Index of the next queue entry to admit. FCFS by default;
        ``class_aware`` batchers prefer the highest ``slo_rank`` (strict
        ``>`` keeps FCFS order within a rank). ``admissible(tier)``
        filters entries (the per-tier quota scan)."""
        best = None
        for i, (rid, _p, _mn, tier) in enumerate(self.queue):
            if admissible is not None and not admissible(tier):
                continue
            if not self.class_aware:
                return i
            r = self._rank_of(rid)
            if best is None or r > best[0]:
                best = (r, i)
        return None if best is None else best[1]

    def freeze_request(self, rid: int) -> Optional[MigrationTicket]:
        """Evacuate a request for live migration: a still-queued request
        lifts out with no KV, an in-slot one (mid-prefill or mid-decode)
        freezes through the cache manager's ``_freeze_slot``. None when the
        rid is unknown or already finished."""
        for i, (qrid, prompt, max_new, tier) in enumerate(self.queue):
            if qrid != rid:
                continue
            self.queue.pop(i)
            getattr(self, "_enc_len", {}).pop(rid, None)
            t = self._tickets.pop(rid, None)
            if self.tracer is not None:
                self._trace("freeze", rid=rid, phase="queued")
            if t is not None:
                return t            # still a ticket: forward untouched
            return MigrationTicket(
                rid=rid, prompt=prompt,
                prompt_ids=self._encode(prompt, max_new), generated=[],
                max_new=max_new, tier=tier, phase="queued",
                log=self.request_log.get(rid))
        for si, s in enumerate(self.slots):
            if s.active and s.request_id == rid:
                self.migration_stats["exports"] += 1
                return self._freeze_slot(si)
        return None

    # ---------------------------------------------------------- expiry
    def cancel_request(self, rid: int) -> bool:
        """Terminally cancel a request at any lifecycle stage (SLO
        expiry): a queued request lifts out of the queue, an in-slot
        request (mid-prefill or mid-decode) releases its cache state
        through the manager's ``_cancel_slot``. Partial output is
        discarded and ``finished`` is NOT written (the caller owns the
        terminal record). False when the rid is unknown or already
        finished, so a request that completed in the tick its deadline
        lapsed is delivered, never resolved twice."""
        for i, (qrid, _p, _mn, tier) in enumerate(self.queue):
            if qrid != rid:
                continue
            self.queue.pop(i)
            self._tickets.pop(rid, None)
            getattr(self, "_enc_len", {}).pop(rid, None)
            self._note_terminal(rid, "expired", tier=tier)
            return True
        for si, s in enumerate(self.slots):
            if s.active and s.request_id == rid:
                self._cancel_slot(si)
                return True
        return False

    def _cancel_slot(self, si):
        """Release slot ``si`` without finishing it (stacked manager: the
        dense row is overwritten at the next admission, nothing to
        free)."""
        s = self.slots[si]
        self._note_terminal(s.request_id, "expired",
                            tokens=len(s.carried) + len(s.generated),
                            tier=s.tier)
        self.slots[si] = SlotState()

    # --------------------------------------------------- fault injection
    def set_slowdown(self, factor: int):
        """Deterministic straggler injection: a work-clock multiplier.
        With factor k, only every k-th ``tick()`` does real work — the
        tick clock still advances every call, so each unit of work takes
        k ticks. Streams are unchanged (skipped ticks do nothing at all);
        factor 1 restores full speed."""
        self.slowdown = max(1, int(factor))
        self._slow_phase = 0

    def _resume_fields(self, s: SlotState) -> dict:
        """Resume-ticket fields of slot ``s``: un-fold the recompute
        context back into (original prompt, full output stream) so a
        ticket never double-counts tokens a previous resume folded into
        ``prompt_ids``."""
        n_folded = len(s.carried)
        orig = (s.prompt_ids[:len(s.prompt_ids) - n_folded] if n_folded
                else list(s.prompt_ids))
        return dict(rid=s.request_id, prompt=s.prompt, prompt_ids=orig,
                    generated=list(s.carried) + list(s.generated),
                    max_new=s.max_new, tier=s.tier,
                    sample_key=s.sample_key,
                    log=self.request_log.get(s.request_id))

    # ------------------------------------------------------ lifecycle notes
    def _note_admission(self, rid, prompt_tokens, slot=None):
        self.stats["admissions"] += 1
        rec = self.request_log.get(rid)
        if rec is not None:
            rec["admit_tick"] = self.stats["ticks"]
            rec["prompt_tokens"] = prompt_tokens
        if self.tracer is not None:
            self._trace("admit", rid=rid, slot=slot,
                        prompt_tokens=prompt_tokens)

    def _note_prefill_dispatch(self, tokens, tier=None, rid=None,
                               slot=None):
        self.stats["prefills"] += 1
        self.stats["prefill_dispatches"] += 1
        self.work_clock += tokens
        self.tier_work[tier] = self.tier_work.get(tier, 0) + tokens
        if self.tracer is not None:
            self._trace("prefill", rid=rid, slot=slot, tokens=tokens,
                        tier=tier)

    def _note_decode_work(self, slot_indices):
        self.work_clock += len(slot_indices)
        for si in slot_indices:
            t = self.slots[si].tier
            self.tier_work[t] = self.tier_work.get(t, 0) + 1
        if self.tracer is not None:
            self._trace("decode",
                        rids=[self.slots[si].request_id
                              for si in slot_indices],
                        slots=list(slot_indices))

    def _note_first_token(self, rid):
        rec = self.request_log.get(rid)
        if rec is not None:
            rec["first_token_tick"] = self.stats["ticks"]
            rec["ttft_ticks"] = rec["first_token_tick"] - rec["submit_tick"]
            rec["ttft_work"] = self.work_clock - rec["submit_work"]
        if self.tracer is not None:
            self._trace("first_token", rid=rid)

    def _note_terminal(self, rid, outcome, tokens=0, tier=None):
        """Stamp a request's terminal record: ``outcome`` is "completed",
        "rejected" (executor-level: could never fit) or "expired"
        (work-clock SLO budget blown: ``cancel_request``). Exactly one
        terminal note per batcher-local rid."""
        rec = self.request_log.get(rid)
        if rec is not None:
            rec["done_tick"] = self.stats["ticks"]
            rec["done_work"] = self.work_clock
            rec["outcome"] = outcome
            rec["generated_tokens"] = tokens
        if self.tracer is not None:
            kind = {"completed": "finish",
                    "expired": "expire"}.get(outcome, "exec_reject")
            self._trace(kind, rid=rid, tokens=tokens, tier=tier)

    def busy(self) -> bool:
        return bool(self.queue) or any(s.active for s in self.slots)

    def tick(self):
        """One engine tick; ``tick_dispatches_max`` records the peak
        number of model dispatches any single tick issued."""
        if self.slowdown > 1:
            # straggler injection: the tick clock advances, the work
            # clock stands still, and nothing is planned, launched or
            # read back
            self._slow_phase = (self._slow_phase + 1) % self.slowdown
            if self._slow_phase != 1:
                self.stats["ticks"] += 1
                return
        d0 = self.stats["device_dispatches"]
        prof = self.profiler
        if prof is None:
            self._tick_inner()
        else:
            shapes = getattr(self, "dispatch_shapes", None)
            k0 = len(shapes) if shapes is not None else 0
            prof.tick_begin()
            self._tick_inner()
            prof.tick_end(self._profile_sync_target())
            if shapes is not None:
                prof.note_shapes(shapes[k0:])
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

    def _next_sample_key(self):
        key = stream_key(self._key_seed, self._keys_issued)
        self._keys_issued += 1
        return key

    def _sample_ready(self, logits, ready):
        """Next token per decode-ready slot from (num_slots, V) logits.
        Sampling state is PER SLOT (``SlotState.sample_key``), so a frozen
        request's stream continues wherever it thaws; greedy (temperature
        0) never consumes a key. One dispatch samples every ready row, and
        the tokens cross to the host once."""
        if self.temperature <= 0.0:
            nxt = self._readback(sample(logits))
            return {si: int(nxt[si]) for si in ready}
        keys = np.zeros((len(ready), 2), np.int64)
        for n, si in enumerate(ready):
            s = self.slots[si]
            keys[n] = s.sample_key
            s.sample_key = (s.sample_key[0], s.sample_key[1] + 1)
        rows = self._to_device(np.asarray(ready, np.int64))
        toks = self._readback(sample(logits.index_select(0, rows),
                                     self._to_device(keys),
                                     self.temperature))
        return {si: int(toks[n]) for n, si in enumerate(ready)}

    def _to_device(self, arr):
        """One host array onto the batcher's device. On the card the copy
        goes through a pinned staging buffer with non_blocking=True, so the
        host does not wait for the device (the caching host allocator keeps
        the buffer alive until the copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _prefill_ids(self, ids):
        """Prefill one token sequence into a fresh (1, max_len) dense cache
        (one device dispatch); returns (greedy next token, cache). The
        token crosses to the host: admission needs it to seed decode."""
        cache = self.model.init_cache(1, self.max_len, dtype=torch.bfloat16,
                                      device=self.device)
        with self._dispatching():
            toks = self._to_device(np.asarray(ids, np.int32)[None])
            logits, cache = self._prefill(self.params, cache, toks)
        self.stats["device_dispatches"] += 1
        return int(self._readback(torch.argmax(logits[0]))), cache

    def _finish_slot(self, si):
        s = self.slots[si]
        self.finished[s.request_id] = self.tok.decode(
            list(s.carried) + list(s.generated))
        self._note_terminal(s.request_id, "completed",
                            tokens=len(s.carried) + len(s.generated),
                            tier=s.tier)
        self.slots[si] = SlotState()


def _write_slot(stacked, one, si):
    """Write a (1, ...) dense cache into row ``si`` of the stacked
    (num_slots, ...) cache, layer by layer and leaf by leaf (attention
    ``k``/``v``, MLA ``ckr``, SSM ``conv``/``h``), in place."""
    for st, o in zip(stacked, one):
        for name, t in st.items():
            t[si] = o[name][0].to(t.dtype)


class ContinuousBatcher(_BatcherBase):
    """Dense stacked-slot cache manager."""

    def __init__(self, cfg, params=None, num_slots=4, max_len=256,
                 seed=0, dtype="float32", temperature=0.0, device=None,
                 class_aware=False):
        super().__init__(cfg, params, num_slots, max_len, seed, dtype,
                         temperature, device, class_aware)
        # stacked slot caches: leading axis = slot
        self._cache = self.model.init_cache(num_slots, max_len,
                                            dtype=torch.bfloat16,
                                            device=self.device)
        self._decode_all = make_serve_step(self.model)

    def _admit(self):
        """Admit queued requests into free slots: one full-prompt prefill
        each. A migration ticket imports its dense row (``_thaw_dense``)
        when it fits, else recomputes its context (prompt + every
        generated token but the last) and continues with its pending
        token."""
        for si, s in enumerate(self.slots):
            if s.active or not self.queue:
                continue
            rid, prompt, max_new, tier = self.queue.pop(self._queue_pick())
            ticket = self._tickets.pop(rid, None)
            if ticket is not None and self._thaw_dense(si, rid, ticket):
                continue
            if ticket is not None:
                ids = ticket.context_ids()
                carried, pending = ticket.progress()
            else:
                ids = self._encode(prompt, max_new)
                carried, pending = [], []
            if len(ids) + max_new - len(carried) - len(pending) \
                    >= self.max_len:
                self.finished[rid] = None       # resumed context outgrew us
                self._note_terminal(rid, "rejected", tier=tier)
                continue
            first, cache = self._prefill_ids(ids)
            _write_slot(self._cache, cache, si)
            sk = (ticket.sample_key if ticket is not None
                  and ticket.sample_key is not None
                  else self._next_sample_key())
            self.slots[si] = SlotState(active=True, request_id=rid,
                                       pos=len(ids), prompt_len=len(ids),
                                       generated=pending or [first],
                                       carried=carried, max_new=max_new,
                                       tier=tier, prompt=prompt,
                                       prompt_ids=list(ids), sample_key=sk)
            if ticket is not None and ticket.resumes_compute():
                self.migration_stats["recomputes"] += 1
            self._note_admission(rid, len(ids), slot=si)
            self._note_prefill_dispatch(len(ids), tier, rid=rid, slot=si)
            if not pending:
                self._note_first_token(rid)

    def _profile_sync_target(self):
        """Device values the profiler waits on at tick end, so in-flight
        work is charged to the tick that launched it (profiling only)."""
        return self._cache

    # ----------------------------------------------------------- migration
    def _leaves(self):
        return [t for layer in self._cache for t in layer.values()]

    def _freeze_slot(self, si) -> MigrationTicket:
        """Export the slot's dense cache row, leaf by leaf as raw bits
        (positions past ``pos`` are never attended, so the whole row ships
        as is)."""
        s = self.slots[si]
        dense = [raw_bits(t[si]).cpu().numpy() for t in self._leaves()]
        t = MigrationTicket(**self._resume_fields(s), kv_tokens=s.pos,
                            dense=dense, max_len=self.max_len,
                            phase="decode")
        if self.tracer is not None:
            self._trace("freeze", rid=s.request_id, slot=si,
                        phase="decode", kv_tokens=s.pos)
        self.slots[si] = SlotState()
        return t

    def _thaw_dense(self, si, rid, t: MigrationTicket) -> bool:
        """Import a stacked ticket's cache row into slot ``si``, bit for
        bit. False (the caller recomputes) when the payload is absent or
        any leaf's shape or element size, or ``max_len``, differs from
        this batcher's cache (an SSM row's conv tail and state, an
        RG-LRU row's rings and state, an MLA row's latents included)."""
        if t.dense is None or t.max_len != self.max_len or not t.generated:
            return False
        context = t.context_ids()
        if t.kv_tokens != len(context):
            return False
        leaves = self._leaves()
        if len(t.dense) != len(leaves) or any(
                tuple(d.shape) != tuple(leaf.shape[1:])
                or d.dtype.itemsize != leaf.element_size()
                for d, leaf in zip(t.dense, leaves)):
            return False
        for d, leaf in zip(t.dense, leaves):
            raw_bits(leaf)[si] = self._to_device(d).view(raw_bits(leaf).dtype)
        sk = (t.sample_key if t.sample_key is not None
              else self._next_sample_key())
        carried, pending = t.progress()
        self.slots[si] = SlotState(active=True, request_id=rid,
                                   pos=t.kv_tokens, prompt_len=len(context),
                                   generated=pending, carried=carried,
                                   max_new=t.max_new, tier=t.tier,
                                   prompt=t.prompt, prompt_ids=context,
                                   sample_key=sk)
        self.migration_stats["imports"] += 1
        self._note_admission(rid, len(context), slot=si)
        return True

    # --------------------------------------------------------------- tick
    def _tick_inner(self):
        """Admit from queue, then ONE decode dispatch over all slots."""
        self._admit()
        self.stats["ticks"] += 1
        active = [si for si, s in enumerate(self.slots) if s.active]
        if not active:
            return
        toks = np.zeros((self.num_slots, 1), np.int32)
        poss = np.zeros((self.num_slots,), np.int32)
        for si in active:
            s = self.slots[si]
            toks[si, 0] = s.generated[-1]
            poss[si] = s.pos
        with self._dispatching():
            logits, self._cache = self._decode_all(
                self.params, self._cache, self._to_device(toks),
                self._to_device(poss))
        self.stats["device_dispatches"] += 1
        nxt = self._sample_ready(logits, active)
        self.stats["decode_steps"] += 1
        self._note_decode_work(active)
        for si in active:
            s = self.slots[si]
            s.generated.append(nxt[si])
            s.pos += 1
            self.stats["decode_tokens"] += 1
            done = (len(s.carried) + len(s.generated) >= s.max_new
                    or s.pos >= self.max_len - 1)
            if done:
                self._finish_slot(si)


class PagedContinuousBatcher(_BatcherBase):
    """Paged-pool cache manager: page-granular allocation, trust-tiered
    prefix sharing, copy-on-write appends, page free at completion.

    ``prefill="chunked"`` (default) turns admission into a prefill QUEUE
    spent by a per-tick token budget; ``prefill="full"`` keeps the
    monolithic single-dispatch admission (the A/B baseline). Chunk pages
    materialize lazily at dispatch via a late-binding re-probe
    (``kvpool.resolve_chunk_page``), so two same-tier requests admitted in
    the same tick still dedup their common head; pages a slot's
    undispatched chunks will need are counted in ``self.reserved`` and are
    off limits to decode-side alloc/COW, so prefill never stalls
    mid-flight."""

    def __init__(self, cfg, params=None, num_slots=4, max_len=256,
                 seed=0, dtype="float32", temperature=0.0, page_size=16,
                 num_pages=None, sharing=True, prefill="chunked",
                 prefill_token_budget=None, fused=True, device=None,
                 constant_shape=False, tier_quotas=None,
                 class_aware=False):
        if not paged_supported(cfg):
            raise ValueError(
                f"paged KV cache requires a full-history attention-only "
                f"pattern, got {sorted(set(effective_pattern(cfg)))}"
                f"{' with attn_window' if cfg.attn_window else ''} — use "
                f"cache='stacked' for this config")
        if prefill not in ("chunked", "full"):
            raise ValueError(f"unknown prefill mode {prefill!r}")
        if constant_shape and not (fused and prefill == "chunked"):
            raise ValueError(
                "constant_shape requires the fused chunked-prefill path "
                "(fused=True, prefill='chunked')")
        if tier_quotas:
            if prefill != "chunked":
                raise ValueError(
                    "tier_quotas require the chunked-prefill path "
                    "(prefill='chunked')")
            if any(c < 1 for c in tier_quotas.values()) \
                    or sum(tier_quotas.values()) > num_slots:
                raise ValueError(
                    f"tier_quotas {tier_quotas} must be >=1 each and sum "
                    f"to at most num_slots={num_slots}")
        super().__init__(cfg, params, num_slots, max_len, seed, dtype,
                         temperature, device, class_aware)
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
        self._decode_all = make_paged_serve_step(self.model)
        self._chunk_prefill = make_chunked_prefill_step(self.model)
        self.prefill_mode = prefill
        # the fused tick covers chunked prefill only
        self.fused = fused and prefill == "chunked"
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
        # per-tier scheduling quotas: a listed tier owns exactly that many
        # slots (a hard cap, even when others idle, and reserved at
        # admission) and a proportional share of the prefill budget;
        # unlisted tiers share the leftover. Deliberately NOT
        # work-conserving, so a tier's admission latency, prefill pace and
        # slot count are independent of every other tier's load. None keeps
        # the shared round-robin scheduler unchanged.
        self.tier_quotas = dict(tier_quotas) if tier_quotas else None
        self._rr_by_class: dict = {}   # quota class -> rotating pointer
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
        # constant-shape dispatch: every bucket pins to its per-kind
        # maximum, so dispatch geometry (and each attention kernel's
        # key-walk split, which follows the shapes) is victim-independent.
        # Padding stays exact-zero masked, and the work clock counts only
        # real tokens
        self.constant_shape = bool(constant_shape)
        self._const_caps = {"rows": num_slots,
                            "chunk": self._chunk_pages_canon,
                            "prefill_w": self.pages_per_seq,
                            "decode_w": self.pages_per_seq}
        # per-tick dispatch geometry log: ("prefill", rows, chunk_pages,
        # table_width) / ("decode", slots, table_width); the observable the
        # launch-shape side channel reads
        self.dispatch_shapes: list = []
        self.stats.update({"share_hits": 0, "cow_copies": 0, "stalls": 0,
                           "preemptions": 0, "rejected_too_large": 0,
                           "prefix_tokens_skipped": 0,
                           "prefill_chunk_tokens": 0})

    # -------------------------------------------------------- fused-tick
    def _bucket(self, kind, need, cap) -> int:
        """Dispatch-shape bucket for ``kind``: the pow2 ceiling of
        ``need`` (capped) — unless a LARGER bucket of this kind was already
        used, in which case that one is reused. Padding is numerically
        free: padded rows/pages write only the scratch page and masked
        attention positions contribute exact zeros. ``constant_shape``
        pins every kind to its per-kind maximum instead."""
        if self.profiler is not None:
            with self.profiler.phase("bucket"):
                return self._bucket_inner(kind, need, cap)
        return self._bucket_inner(kind, need, cap)

    def _bucket_inner(self, kind, need, cap) -> int:
        need = max(1, min(need, cap))
        if self.constant_shape:
            fixed = self._const_caps[kind]
            assert need <= fixed, \
                f"{kind} dispatch ({need}) overflows constant shape {fixed}"
            return fixed
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
        (the only device sync of the fused path: finish, freeze and
        preemption)."""
        s = self.slots[si]
        if not s.gen_dev:
            return
        lo = len(s.generated)
        vals = self._readback(self._dev_gen[si, lo:lo + s.gen_dev])
        s.generated.extend(int(v) for v in vals)
        s.gen_dev = 0

    def _finish_slot(self, si):
        self._materialize_slot(si)
        super()._finish_slot(si)

    def _profile_sync_target(self):
        return (self.pool.pages, self._dev_gen) if self.fused \
            else self.pool.pages

    # ---------------------------------------------------------- admission
    def _admit(self):
        if self.prefill_mode == "full":
            self._admit_full()
        else:
            self._admit_chunked(self._quota_admits if self.tier_quotas
                                else None)

    def _admit_full(self):
        """Monolithic admission (the pre-chunking baseline): one blocking
        full-prompt prefill dispatch per admitted request, scattered into
        the pool in one whole-admission write. A preempted request
        re-admits through the SAME path as a recompute of its context: its
        pending token survives, so its stream continues where it
        stopped."""
        for si, s in enumerate(self.slots):
            if s.active:
                continue
            qi = self._queue_pick()
            if qi is None:
                break
            rid, prompt, max_new, tier = self.queue[qi]
            ticket = self._tickets.get(rid)
            if ticket is not None:
                ids = ticket.context_ids()
                carried, pending = ticket.progress()
            else:
                ids = self._encode(prompt, max_new)
                carried, pending = [], []
            chunks = prefix_chunk_hashes(ids, self.page_size)
            counters0 = self.pool.snapshot_share_counters()
            shared = []
            for chash, fill in chunks:
                pid = self.pool.lookup_prefix(tier, chash, fill)
                if pid is None:
                    break
                shared.append(pid)
            n_fresh = len(chunks) - len(shared)
            # a sequence must be able to run ALONE (context + every decode
            # token still owed) or preemption can never rescue it: reject
            # just this request (a None result)
            total = len(ids) + max_new - len(carried) - len(pending)
            if total >= self.max_len \
                    or -(-total // self.page_size) \
                    > self.pool.num_pages - 1:
                self.queue.pop(qi)
                self._tickets.pop(rid, None)
                self.finished[rid] = None
                self.stats["rejected_too_large"] += 1
                self._note_terminal(rid, "rejected", tier=tier)
                continue
            if self.pool.free_count() < n_fresh:
                # pool exhausted — leave the request queued (eviction
                # pressure); the probe must not count toward the share-hit
                # telemetry
                self.pool.restore_share_counters(counters0)
                self.pool.stats["blocked"] += 1
                self.blocked_last_tick += 1
                break
            self.queue.pop(qi)
            self._tickets.pop(rid, None)
            for pid in shared:
                self.pool.incref(pid)
            pages = list(shared)
            for _ in range(n_fresh):
                pages.append(self.pool.alloc(tier))
            # full-context prefill; shared pages already hold identical
            # K/V, so only fresh chunks are scattered into the pool
            first, dense = self._prefill_ids(ids)
            self.pool.write_prompt_pages(
                dense, [SCRATCH_PAGE] * len(shared) + pages[len(shared):])
            for j in range(len(shared), len(chunks)):
                chash, fill = chunks[j]
                self.pool.register_prefix(pages[j], tier, chash, fill)
            row = np.zeros(self.pages_per_seq, np.int32)
            row[:len(pages)] = pages
            self.block_tables[si] = row
            sk = (ticket.sample_key if ticket is not None
                  and ticket.sample_key is not None
                  else self._next_sample_key())
            self.slots[si] = SlotState(active=True, request_id=rid,
                                       pos=len(ids), prompt_len=len(ids),
                                       generated=pending or [first],
                                       carried=carried, max_new=max_new,
                                       pages=pages, tier=tier,
                                       shared_pages=len(shared),
                                       prompt=prompt, prompt_ids=list(ids),
                                       sample_key=sk)
            self.stats["share_hits"] += len(shared)
            if ticket is not None and ticket.resumes_compute():
                self.migration_stats["recomputes"] += 1
            self._note_admission(rid, len(ids), slot=si)
            self._note_prefill_dispatch(len(ids), tier, rid=rid, slot=si)
            if not pending:
                self._note_first_token(rid)

    def _admit_chunked(self, admissible=None):
        """Plan-only admission: split the prompt into page-size chunks,
        attach to every leading chunk already cached at this exact trust
        tier, and queue the rest for budgeted dispatch by
        ``_prefill_tick``. No model dispatch happens here. A preempted
        request's resume ticket re-admits as a recompute of its context.
        ``class_aware`` batchers admit the most urgent SLO rank first
        (``_queue_pick``) instead of strict FCFS. With ``tier_quotas`` the
        queue is SCANNED (``admissible`` is ``_quota_admits``): a request
        whose tier is at its cap is skipped, not waited on, so one tier's
        backlog cannot delay another tier's admission."""
        for si, s in enumerate(self.slots):
            if s.active:
                continue
            qi = self._queue_pick(admissible)
            if qi is None:
                break            # empty queue, or every queued tier capped
            rid, prompt, max_new, tier = self.queue[qi]
            ticket = self._tickets.get(rid)
            if ticket is not None:
                status = self._admit_ticket(si, rid, ticket)
            else:
                ids = self._encode(prompt, max_new)
                status = self._admit_ids(si, rid, ids, max_new, tier,
                                         prompt)
            if status == "blocked":
                # pool exhausted once other slots' pending chunks are
                # counted — leave the request queued (eviction pressure)
                self.pool.stats["blocked"] += 1
                self.blocked_last_tick += 1
                break
            self.queue.pop(qi)
            self._tickets.pop(rid, None)
            self._enc_len.pop(rid, None)

    # ------------------------------------------------- per-tier quotas
    def _quota_admits(self, tier) -> bool:
        """Whether a request of ``tier`` may take a slot now: a listed tier
        uses at most its cap; unlisted tiers share the slots no quota
        reserves. Hard caps both ways, so one tier's occupancy is
        invisible to another's admission latency."""
        caps = self.tier_quotas
        if tier in caps:
            used = sum(1 for s in self.slots
                       if s.active and s.tier == tier)
            return used < caps[tier]
        used = sum(1 for s in self.slots
                   if s.active and s.tier not in caps)
        return used < self.num_slots - sum(caps.values())

    def _prefill_tick_quota(self):
        """Quota-aware budgeted prefill: the token budget splits into
        per-class shares (a listed tier gets ``budget * cap / num_slots``,
        unlisted tiers the remainder), and each class runs its own rotating
        round-robin over its own slots. A class that spends its share
        stops; nobody inherits leftover budget (not work-conserving on
        purpose). Every planned row still fuses into ONE dispatch."""
        caps = self.tier_quotas
        total = self.prefill_token_budget
        shares = {t: total * c // self.num_slots for t, c in caps.items()}
        shares[None] = total - sum(shares.values())   # unlisted tiers
        rows = []
        n = self.num_slots
        for key, budget in shares.items():
            start = self._rr_by_class.get(key, 0)
            progress = True
            while budget > 0 and progress:
                progress = False
                for k in range(n):
                    if budget <= 0:
                        break
                    si = (start + k) % n
                    s = self.slots[si]
                    if not (s.active and s.next_chunk < len(s.chunks)):
                        continue
                    if (s.tier != key) if key is not None \
                            else (s.tier in caps):
                        continue
                    if self.fused:
                        row, gtok = self._plan_prefill_row(si, budget)
                        if row is not None:
                            rows.append(row)
                        budget -= gtok
                    else:
                        budget -= self._advance_prefill(si, budget)
                    self._rr_by_class[key] = (si + 1) % n
                    progress = True
                if self.constant_shape:
                    break        # one pass at most (see _prefill_tick)
        if rows:
            self._execute_prefill_rows(rows)

    def _admit_ids(self, si, rid, ids, max_new, tier, prompt, carried=(),
                   pending=()):
        """Plan-only admission of a token sequence into slot ``si``, for
        fresh requests and preemption re-admissions. ``carried``/
        ``pending`` restore a resumed request's generation progress
        (``pending`` holds the token already sampled but not yet fed
        through the model); both empty means a fresh request whose first
        token comes from the final chunk's boundary logits. Returns
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
        # alone-fit rejection: context plus every still-owed decode token
        # must fit max_len and its worst-case pages must fit the pool alone
        total = len(ids) + max_new - len(carried) - len(pending)
        if total >= self.max_len \
                or -(-total // self.page_size) > self.pool.num_pages - 1:
            self.finished[rid] = None
            self.stats["rejected_too_large"] += 1
            self._note_terminal(rid, "rejected", tier=tier)
            return "rejected"
        # the plan holds every chunk that must DISPATCH: fresh chunks, plus
        # the last chunk even when shared IF the first token is still owed
        # (its boundary logits are that token; it dispatches against the
        # scratch page so the shared page is never rewritten); a resumed
        # request already holds its next token, so a fully shared context
        # skips everything
        plan = []
        skipped = 0
        for j, (chash, fill) in enumerate(chunks):
            if j < len(shared) and (j < len(chunks) - 1 or pending):
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
                                   prompt_len=len(ids),
                                   generated=list(pending),
                                   carried=list(carried), max_new=max_new,
                                   pages=list(shared), tier=tier,
                                   shared_pages=len(shared), prompt=prompt,
                                   prompt_ids=list(ids), chunks=plan,
                                   next_chunk=0,
                                   sample_key=self._next_sample_key())
        if not plan:                    # fully shared resumed context:
            self.slots[si].pos = len(ids)    # decode-ready immediately
        self.stats["share_hits"] += len(shared)
        self.stats["prefix_tokens_skipped"] += skipped
        self._note_admission(rid, len(ids), slot=si)
        rec = self.request_log.get(rid)
        if rec is not None:
            rec["tokens_skipped"] = rec.get("tokens_skipped", 0) + skipped
        return "ok"

    def _admit_ticket(self, si, rid, t: MigrationTicket):
        """Thaw a migration or resume ticket into slot ``si``. When the
        payload is compatible (page records at this pool's page size, an
        admissible tier, room for the import plus reservations for the
        chunks the source had not prefilled yet) the KV pages import
        directly: prefix-keyed records re-attach to this pool's own
        same-tier pages where the chain hash matches, the rest deep-copy.
        Any fail-closed refusal (untiered, tier mismatch, no bytes) or
        structural mismatch falls back to recomputing the context (prompt
        + every generated token but the last) from tokens. Either way the
        request keeps its generation progress and sampling key, so the
        continued stream is the one the source would have produced."""
        context = t.context_ids()
        carried, pending = t.progress()
        if not ticket_fits(t, self.max_len, self.page_size,
                           self.pool.num_pages):
            self.finished[rid] = None
            self.stats["rejected_too_large"] += 1
            self._note_terminal(rid, "rejected", tier=t.tier)
            return "rejected"
        ps = self.page_size
        if t.pages and t.page_size == ps:
            chunks = prefix_chunk_hashes(context, ps)
            kv_chunks = len(t.pages)
            if kv_chunks <= len(chunks) and kv_chunks <= self.pages_per_seq \
                    and t.kv_tokens == min(kv_chunks * ps, len(context)):
                plan = [(j,) + chunks[j]
                        for j in range(kv_chunks, len(chunks))]
                if not pending and not plan:
                    # mid-prefill freeze where every page was shared: the
                    # first token is still owed, so the last chunk replays
                    # for its boundary logits (scratch-masked write)
                    j = len(chunks) - 1
                    plan = [(j,) + chunks[j]]
                n_fresh = sum(1 for (j, _h, _f) in plan if j >= kv_chunks)
                if self.pool.free_count() - self.reserved \
                        < len(t.pages) + n_fresh:
                    return "blocked"
                res = import_request(self.pool, t.pages, t.tier)
                if res is not None:
                    page_ids, copied, hits = res
                    row = np.zeros(self.pages_per_seq, np.int32)
                    row[:len(page_ids)] = page_ids
                    self.block_tables[si] = row
                    self.reserved += n_fresh
                    sk = (t.sample_key if t.sample_key is not None
                          else self._next_sample_key())
                    self.slots[si] = SlotState(
                        active=True, request_id=rid,
                        pos=len(context) if not plan else 0,
                        prompt_len=len(context), generated=pending,
                        carried=carried, max_new=t.max_new,
                        pages=list(page_ids), tier=t.tier,
                        shared_pages=hits, prompt=t.prompt,
                        prompt_ids=context, chunks=plan, next_chunk=0,
                        sample_key=sk)
                    self.migration_stats["imports"] += 1
                    self.migration_stats["imported_pages"] += copied
                    self.migration_stats["import_attach_hits"] += hits
                    self._note_admission(rid, len(context), slot=si)
                    return "ok"
        # recompute-from-tokens fallback (forbidden or impossible import)
        status = self._admit_ids(si, rid, context, t.max_new, t.tier,
                                 t.prompt, carried=carried, pending=pending)
        if status == "ok":
            if t.resumes_compute():
                self.migration_stats["recomputes"] += 1
            if t.sample_key is not None:
                self.slots[si].sample_key = t.sample_key
        return status

    # ------------------------------------------------------ chunked prefill
    def _prefill_tick(self):
        """Sarathi-style budgeted prefill: spend up to
        ``prefill_token_budget`` prompt tokens on queued chunks, round-
        robin across slots (prefix-skipped chunks are free). The pointer
        ROTATES, so even a budget of one chunk per tick cannot starve a
        short prompt behind a long one. Fused, every planned row goes into
        ONE device dispatch; unfused, each run dispatches as it is
        planned. ``class_aware`` batchers serve higher SLO ranks first
        (a stable sort keeps the rotation order within a rank)."""
        budget = self.prefill_token_budget
        n = self.num_slots
        start = self._prefill_rr
        order = [(start + k) % n for k in range(n)]
        if self.class_aware:
            order.sort(key=lambda si: -self._slot_rank(si))
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
                if self.fused:
                    row, gtok = self._plan_prefill_row(si, budget)
                    if row is not None:
                        rows.append(row)
                    budget -= gtok
                else:
                    budget -= self._advance_prefill(si, budget)
                self._prefill_rr = (si + 1) % n
                progress = True
            if self.constant_shape:
                # one round-robin pass at most: one planned row a slot, so
                # the fused prefill's row count pins to num_slots (leftover
                # budget rolls to the next tick)
                break
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

    def _advance_prefill(self, si, budget) -> int:
        """Unfused prefill step: plan one chunk run for slot ``si`` and
        dispatch it immediately. Completing the plan emits the first
        token from the run's boundary logits (a host sync). Returns the
        tokens dispatched."""
        s = self.slots[si]
        group, gtok = self._plan_group(si, budget)
        if not group:                 # the last chunk always dispatches
            return 0
        logits = self._dispatch_chunks(si, group)
        for j, chash, fill, dst in group:
            if dst != SCRATCH_PAGE:
                # register AFTER the write so an index hit is always
                # readable (late attaches depend on this ordering)
                self.pool.register_prefix(dst, s.tier, chash, fill)
        if s.next_chunk == len(s.chunks):
            s.pos = s.prompt_len
            if not s.generated:
                # prompt complete: the boundary logits are the first token
                # (a resumed request already holds its pending token)
                off = (s.prompt_len - 1) - group[0][0] * self.page_size
                s.generated = [int(self._readback(
                    torch.argmax(logits[0, off])))]
                self._note_first_token(s.request_id)
        return gtok

    def _dispatch_chunks(self, si, group):
        """ONE model dispatch for a run of consecutive chunks of slot
        ``si``: the run pads to the next power-of-two page count (capped by
        the budget) and the block table trims to the next power-of-two
        width covering the run's last page, as the reference buckets its
        compiled shapes. Padding writes only the scratch page. Returns the
        run's logits (1, pages * page_size, V)."""
        s = self.slots[si]
        ps = self.page_size
        start = group[0][0] * ps
        c = min(1 << (len(group) - 1).bit_length(), self._chunk_pages_canon)
        w = min(1 << group[-1][0].bit_length(), self.pages_per_seq)
        self.dispatch_shapes.append(("prefill", 1, c, w))
        toks = np.zeros((1, c * ps), np.int32)
        dst = np.zeros(c, np.int32)                         # pad -> scratch
        fills = 0
        for n, (j, _h, fill, d) in enumerate(group):
            toks[0, n * ps:n * ps + fill] = s.prompt_ids[j * ps:j * ps + fill]
            dst[n] = d
            fills += fill
        dev = self._to_device
        with self._dispatching():
            logits, self.pool.pages = self._chunk_prefill(
                self.params, self.pool.pages, dev(toks),
                dev(np.asarray([start], np.int32)),
                dev(self.block_tables[si:si + 1, :w]), dev(dst))
        self.stats["device_dispatches"] += 1
        self.stats["prefill_chunk_tokens"] += fills
        self._note_prefill_dispatch(fills, s.tier, rid=s.request_id,
                                    slot=si)
        return logits

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
        self._note_prefill_dispatch(gtok, s.tier, rid=s.request_id,
                                    slot=si)
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
        r_n = self._bucket("rows", len(rows),
                           self.num_slots if self.constant_shape else 1 << 16)
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
        with self._dispatching():
            self._dev_last, self._dev_gen, self.pool.pages = \
                self._fused_prefill(
                    self.params, self.pool.pages, dev(toks), dev(starts),
                    dev(bt), dev(dst), dev(emit_slot), dev(emit_off),
                    dev(gen_idx), self._dev_last, self._dev_gen)
        self.stats["device_dispatches"] += 1

    # ----------------------------------------------------------- migration
    def _freeze_slot(self, si) -> MigrationTicket:
        """Export the slot's live KV pages and evacuate it. A mid-prefill
        slot's unfinished chunk plan travels implicitly: the ticket records
        how many context tokens the exported pages cover, and the
        destination rebuilds the rest of the plan from the tokens (chain
        hashes are content-derived). The reservations of its undispatched
        chunks return to the pool."""
        self._materialize_slot(si)      # fused ticks leave a device tail
        s = self.slots[si]
        ps = self.page_size
        mid_prefill = s.next_chunk < len(s.chunks)
        self.reserved -= sum(1 for (j, _h, _f) in s.chunks[s.next_chunk:]
                             if j >= len(s.pages))
        kv_tokens = (min(len(s.pages) * ps, s.prompt_len) if mid_prefill
                     else s.pos)
        records = export_request(self.pool, list(s.pages), kv_tokens)
        t = MigrationTicket(**self._resume_fields(s), kv_tokens=kv_tokens,
                            page_size=ps, pages=records,
                            phase="prefill" if mid_prefill else "decode")
        if self.tracer is not None:
            self._trace("freeze", rid=s.request_id, slot=si,
                        phase=t.phase, kv_tokens=kv_tokens,
                        pages=len(records))
        self.block_tables[si] = 0
        self.slots[si] = SlotState()
        return t

    def _cancel_slot(self, si):
        """Release slot ``si`` without finishing it (SLO expiry): free its
        pages, return the reservations its undispatched chunks hold,
        clear its block table. A fused slot's device-resident token tail
        is dropped unread: ``gen_dev`` leaves with the slot (a fresh
        ``SlotState``), so the next request admitted here starts from the
        host-known tokens its admission seeds, and idle rows decode
        against the scratch page. The expire terminal counts the tail's
        tokens, which the host knows without reading them."""
        s = self.slots[si]
        self.reserved -= sum(1 for (j, _h, _f) in s.chunks[s.next_chunk:]
                             if j >= len(s.pages))
        for pid in s.pages:
            self.pool.decref(pid)
        self.block_tables[si] = 0
        self._note_terminal(
            s.request_id, "expired",
            tokens=len(s.carried) + len(s.generated) + s.gen_dev,
            tier=s.tier)
        self.slots[si] = SlotState()

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
        spend the prefill token budget on queued chunks, then ONE paged
        decode step for every slot whose prompt is fully prefilled."""
        self.blocked_last_tick = 0
        self._admit()
        self.stats["ticks"] += 1
        if self.prefill_mode == "chunked":
            if self.tier_quotas:
                self._prefill_tick_quota()
            else:
                self._prefill_tick()
        active = [si for si, s in enumerate(self.slots)
                  if s.active and s.next_chunk >= len(s.chunks)]
        if not active:
            return
        ready, stalled = [], []
        for si in active:
            if self._prepare_write_page(si):
                ready.append(si)
            else:
                stalled.append(si)
                self.stats["stalls"] += 1
                self.blocked_last_tick += 1
        while not ready and stalled:
            self._preempt_one(stalled)
            for si in list(stalled):
                if self._prepare_write_page(si):
                    ready.append(si)
                    stalled.remove(si)
        if not ready:
            return
        if self.fused:
            self._decode_fused(ready)
        else:
            self._decode_unfused(ready)

    def _preempt_one(self, stalled):
        """EVERY decode-ready slot is blocked on page exhaustion: without
        intervention no slot can decode, finish or free — a deadlock.
        Preempt the least-invested sequence (fewest tokens to recompute)
        among the stalled and the mid-prefill slots (whose reserved pages
        can be what starves a lone decoder): release its pages and
        requeue it at the head with a resume ticket that keeps its
        generated tokens. The freed pages go to the survivors in this
        tick."""
        prefilling = [si for si, s in enumerate(self.slots)
                      if s.active and s.next_chunk < len(s.chunks)]

        def invested(si):
            s = self.slots[si]
            return (len(s.pages) * self.page_size + len(s.generated)
                    + s.gen_dev)

        # class-aware: victims come from the class with the most SLO
        # headroom first (lowest slo_rank); least-invested breaks ties
        if self.class_aware:
            victim = min(stalled + prefilling,
                         key=lambda si: (self._slot_rank(si), invested(si)))
        else:
            victim = min(stalled + prefilling, key=invested)
        if victim in stalled:
            stalled.remove(victim)
        # the resume ticket needs the victim's whole stream on the host
        self._materialize_slot(victim)
        s = self.slots[victim]
        # release the reservations its undispatched fresh chunks hold
        self.reserved -= sum(1 for (j, _h, _f) in s.chunks[s.next_chunk:]
                             if j >= len(s.pages))
        for pid in s.pages:
            self.pool.decref(pid)
        self.block_tables[victim] = 0
        self.queue.insert(0, (s.request_id, s.prompt, s.max_new, s.tier))
        if s.generated or s.carried:
            self._tickets[s.request_id] = MigrationTicket(
                **self._resume_fields(s), phase="queued")
        self.preempted_rids.append(s.request_id)
        if self.tracer is not None:
            self._trace("preempt", rid=s.request_id, slot=victim,
                        invested=invested(victim))
        self.slots[victim] = SlotState()
        self.stats["preemptions"] += 1

    def _decode_unfused(self, ready):
        """Unfused decode: one paged dispatch over all slots whose logits
        come back to the host, where the next tokens are taken. Stalled
        and inactive rows keep all-zero tables, so their dummy token lands
        on the scratch page; the table trims to the pages any sequence
        occupies."""
        toks = np.zeros((self.num_slots, 1), np.int32)
        poss = np.zeros((self.num_slots,), np.int32)
        bt = np.zeros_like(self.block_tables)
        for si in ready:
            s = self.slots[si]
            toks[si, 0] = s.generated[-1]
            poss[si] = s.pos
            bt[si] = self.block_tables[si]
        n_live = max(self.slots[si].pos // self.page_size + 1
                     for si in ready)
        self.dispatch_shapes.append(("decode", self.num_slots, n_live))
        dev = self._to_device
        with self._dispatching():
            logits, self.pool.pages = self._decode_all(
                self.params, self.pool.pages, dev(toks), dev(poss),
                dev(bt[:, :n_live]))
        self.stats["device_dispatches"] += 1
        nxt = self._sample_ready(logits, ready)
        self.stats["decode_steps"] += 1
        self._note_decode_work(ready)
        for si in ready:
            s = self.slots[si]
            s.generated.append(nxt[si])
            s.pos += 1
            self.stats["decode_tokens"] += 1
            done = (len(s.carried) + len(s.generated) >= s.max_new
                    or s.pos >= self.max_len - 1)
            if done:
                for pid in s.pages:
                    self.pool.decref(pid)
                self.block_tables[si] = 0
                self._finish_slot(si)

    def _decode_fused(self, ready):
        """Fused-tick decode: one dispatch whose input tokens resolve ON
        DEVICE — a slot's last token is host-known only while
        ``gen_dev == 0`` (admission-seeded or host-sampled); otherwise it
        lives in ``_dev_last`` where earlier dispatches left it. Greedy
        next tokens append to the device-resident stream. Stochastic
        sampling must see the logits anyway, so temperature > 0
        materializes the ready slots and samples on the host side of the
        tick, exactly as the unfused path does."""
        greedy = self.temperature <= 0.0
        if not greedy:
            for si in ready:
                self._materialize_slot(si)
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
            if greedy:
                write_slot[si] = si
                gen_idx[si] = len(s.generated) + s.gen_dev
        # idle/stalled rows: host_mask stays False and their stale
        # _dev_last token decodes against the scratch page (all-zero table)
        w = self._bucket("decode_w",
                         max(self.slots[si].pos // self.page_size + 1
                             for si in ready), self.pages_per_seq)
        self.dispatch_shapes.append(("decode", self.num_slots, w))
        dev = self._to_device
        with self._dispatching():
            logits, self._dev_last, self._dev_gen, self.pool.pages = \
                self._fused_decode(
                    self.params, self.pool.pages, self._dev_last,
                    dev(host_mask), dev(toks), dev(poss), dev(bt[:, :w]),
                    dev(write_slot), dev(gen_idx), self._dev_gen)
        self.stats["device_dispatches"] += 1
        nxt = None if greedy else self._sample_ready(logits, ready)
        self.stats["decode_steps"] += 1
        self._note_decode_work(ready)
        for si in ready:
            s = self.slots[si]
            if greedy:
                s.gen_dev += 1
            else:
                s.generated.append(nxt[si])
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
    """Paged decode handles full-history attention-only patterns; windowed
    attention (ring-buffer slots) and ssm/rglru/mla state stay stacked."""
    return set(effective_pattern(cfg)) == {"attn"} and not cfg.attn_window


def make_batcher(cfg, cache: str = "auto", **kw):
    """Factory: ``cache`` in {"auto", "paged", "stacked"} — auto picks the
    paged pool whenever the architecture supports it."""
    if cache == "auto":
        cache = "paged" if paged_supported(cfg) else "stacked"
    if cache == "paged":
        return PagedContinuousBatcher(cfg, **kw)
    if cache == "stacked":
        for k in ("page_size", "num_pages", "sharing", "prefill",
                  "prefill_token_budget", "fused", "constant_shape",
                  "tier_quotas"):
            kw.pop(k, None)
        return ContinuousBatcher(cfg, **kw)
    raise ValueError(f"unknown cache manager {cache!r}")
