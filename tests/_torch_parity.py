"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Token streams of the port and of the reference are compared path for
path under a MARGIN RULE: with bf16 KV pages on a random-weight model,
greedy argmax can flip on a near-tie (ROADMAP R1: a top-2 logit margin of
0.0017), so a mismatch is a fault only where the reference's own top-2
margin at that step exceeds ``MARGIN``; after a legitimate near-tie
divergence the two streams continue from different tokens, so the
comparison of that stream stops there.

``MARGIN`` is set from the logit differences the port shows against the
reference with bf16 pages on the test models (at most 1.1e-4, held under
1e-3 by test_torch_bridge_model.py): a step whose margin is above it
cannot flip unless the port is wrong.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

MARGIN = 5e-3


class _OtherDevice(torch.Tensor):
    """A tensor's shape, dtype and device with no storage, on a device
    the port has no kernel for; any op on it raises."""

    @staticmethod
    def __new__(cls, shape, dtype):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype,
                                                   device="xla")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} ran on a stand-in tensor")


def other_device(shape, dtype=torch.float32) -> torch.Tensor:
    """A stand-in tensor on the ``xla`` device: a kernel wrapper must
    refuse it (neither CUDA nor a plain version's CPU or meta)."""
    return _OtherDevice(tuple(shape), dtype)


def top2_margin(logits_row) -> float:
    top = np.sort(np.asarray(logits_row, np.float32))[-2:]
    return float(top[1] - top[0])


def reference_steps(model):
    """The reference's fused steps, jitted once so that several batchers
    of one config share compiled programs, plus the chunk forward whose
    logits give the margins of boundary tokens."""
    from repro.models.steps import (make_fused_decode_step,
                                    make_fused_prefill_step)
    return {
        "prefill": jax.jit(make_fused_prefill_step(model),
                           donate_argnums=(1,)),
        "decode": jax.jit(make_fused_decode_step(model),
                          donate_argnums=(1,)),
        "chunk_logits": jax.jit(
            lambda params, pages, tok, start, bt, dst: model.forward(
                params, mode="chunk", tokens=tok, cache=pages, pos=start,
                block_table=bt, dst_page=dst)[0]),
    }


def capture_reference(b, steps):
    """Wrap a reference ``PagedContinuousBatcher`` (fused, greedy) so it
    records, per request id, the full token stream and the top-2 margin of
    the logits behind every generated token (keyed by the token's index in
    the stream, which a preempted request continues); ``steps`` comes from
    ``reference_steps``. Returns (tokens, margins) dicts filled as the
    batcher runs."""
    tokens, margins = {}, {}
    chunk_logits = steps["chunk_logits"]
    fused_prefill, fused_decode = steps["prefill"], steps["decode"]

    def prefill(params, pages, tok, start, bt, dst, emit_slot, emit_off,
                gen_idx, last, gen):
        emits = np.asarray(emit_slot) < b.num_slots
        lg = (np.asarray(chunk_logits(params, pages, tok, start, bt, dst))
              if emits.any() else None)
        for r, si in enumerate(np.asarray(emit_slot)):
            if emits[r]:
                rid = b.slots[si].request_id
                margins.setdefault(rid, {})[int(gen_idx[r])] = \
                    top2_margin(lg[r, int(emit_off[r])])
        return fused_prefill(params, pages, tok, start, bt, dst, emit_slot,
                             emit_off, gen_idx, last, gen)

    def decode(params, pages, last, host_mask, host_tok, pos, bt,
               write_slot, gen_idx, gen):
        out = fused_decode(params, pages, last, host_mask, host_tok, pos,
                           bt, write_slot, gen_idx, gen)
        lg = np.asarray(out[0])
        for si, ws in enumerate(np.asarray(write_slot)):
            if ws == si:
                s = b.slots[si]        # a resumed slot's stream continues
                margins.setdefault(s.request_id, {})[
                    len(s.carried) + int(gen_idx[si])] = top2_margin(lg[si])
        return out

    b._fused_prefill, b._fused_decode = prefill, decode
    _record_streams(b, tokens)
    return tokens, margins


def capture_reference_host(b):
    """Wrap a reference batcher whose tokens are taken on the host — the
    stacked ``ContinuousBatcher``, or a ``PagedContinuousBatcher`` with
    ``prefill="full"`` or ``fused=False`` — so it records, per request id,
    the full token stream and the top-2 margin of the logits behind every
    generated token (keyed by the token's index in the stream). Returns
    (tokens, margins) dicts filled as the batcher runs."""
    tokens, margins = {}, {}
    last = {}

    def note(si, logits_row):
        s = b.slots[si]
        margins.setdefault(s.request_id, {})[
            len(s.carried) + len(s.generated)] = top2_margin(logits_row)

    prefill = b._prefill

    def pre(params, cache, inputs):      # first token of a full prefill
        out = prefill(params, cache, inputs)
        last["first"] = np.asarray(out[0][0])
        return out

    first_token = b._note_first_token

    def first(rid):
        if "first" in last:
            margins.setdefault(rid, {})[0] = top2_margin(last.pop("first"))
        first_token(rid)

    decode = b._decode_all
    paged = hasattr(b, "pool")

    def dec(params, cache, toks, poss, *bt):
        out = decode(params, cache, toks, poss, *bt)
        lg = np.asarray(out[0]).reshape(b.num_slots, -1)
        rows = (np.asarray(bt[0])[:, 0] != 0 if paged
                else [s.active for s in b.slots])
        for si, live in enumerate(rows):
            if live:
                note(si, lg[si])
        return out

    b._prefill, b._note_first_token, b._decode_all = pre, first, dec
    if paged and not b.fused:
        dispatch = b._dispatch_chunks

        def chunks(si, group):           # a boundary token of a chunk run
            logits = dispatch(si, group)
            s = b.slots[si]
            if s.next_chunk == len(s.chunks) and not s.generated:
                off = (s.prompt_len - 1) - group[0][0] * b.page_size
                last["first"] = np.asarray(logits[0, off])
            return logits

        b._dispatch_chunks = chunks
    _record_streams(b, tokens)
    return tokens, margins


def capture_port(b):
    """Record the port batcher's full token stream per request id."""
    tokens = {}
    _record_streams(b, tokens)
    return tokens


def _record_streams(b, tokens):
    finish = b._finish_slot

    def record(si):
        if hasattr(b, "_materialize_slot"):
            b._materialize_slot(si)
        s = b.slots[si]
        tokens[s.request_id] = list(s.carried) + list(s.generated)
        finish(si)

    b._finish_slot = record


def assert_streams_match(ref_tokens, ref_margins, port_tokens,
                         margin=MARGIN):
    """Every stream equal token for token, except after a first mismatch
    at a step whose reference margin is at most ``margin``. Returns the
    number of streams that diverged legitimately."""
    assert sorted(ref_tokens) == sorted(port_tokens)
    diverged = 0
    for rid, want in ref_tokens.items():
        got = port_tokens[rid]
        assert len(got) == len(want), (rid, got, want)
        for k, (a, b) in enumerate(zip(got, want)):
            if a == b:
                continue
            m = ref_margins[rid][k]
            assert m <= margin, (
                f"request {rid} token {k}: port {a} != reference {b} at a "
                f"reference top-2 margin of {m:.4g} > {margin}")
            diverged += 1
            break
    return diverged


def port_request(req, module):
    """The same ``Request`` rebuilt from the port's copy of ``waves``."""
    return module.Request(**dataclasses.asdict(req))


_REFERENCE_STEP_FNS = ("get_model", "make_chunked_prefill_step",
                       "make_fused_decode_step", "make_fused_prefill_step",
                       "make_paged_serve_step", "make_prefill_step",
                       "make_serve_step")


@pytest.fixture(scope="module")
def lean_cpu():
    """For a module that builds dozens of batchers in both packages (the
    adversary suite builds 17 a run): every reference batcher shares one
    model and one set of step functions per config, so ``jax.jit``
    compiles each program once instead of once a batcher, and torch runs
    one thread, which keeps its many small CPU ops from spinning against
    the other test workers' threads. Neither changes a program or a
    result. Restored when the module ends."""
    from repro.serving import batcher as jbatcher
    mp = pytest.MonkeyPatch()
    for name in _REFERENCE_STEP_FNS:
        mp.setattr(jbatcher, name,
                   functools.lru_cache(None)(getattr(jbatcher, name)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    mp.undo()
