"""deepseek-v2-lite-16b and kimi-k2-1t-a32b served by the port against
the reference, at ``.reduced()`` widths with bridged weights, on the paths
the reference gives them.

``make_batcher(cache="auto")`` gives deepseek (MLA: its ``ckr`` latent is
no attention K/V) the stacked ``ContinuousBatcher`` in both packages, and
kimi (MoE on GQA attention) the fused chunked paged batcher. Each path is
compared with the same path of the reference:

* every deterministic host integer is equal (stats, work clock, dispatch
  geometry, lifecycle records, pool telemetry);
* streams are equal under the margin rule of ``_torch_parity`` (ROADMAP
  R1: bf16 caches on a random-weight model make greedy argmax fragile at
  near-ties).

At temperature 0.9 ``jax.random`` draws cannot be matched (ROADMAP R2):
the host integers are equal, the first tokens (greedy at any
temperature, R7) follow the margin rule, and every sampled token of the
port is the argmax of the port's perturbed scores over the REFERENCE's
logits for the port's own stream (the reference's model decoding it
with a bf16 cache, as its stacked batcher does), except at a near tie
of those scores.

A stacked deepseek slot freezes and thaws bit for bit (its ``ckr`` rows
as raw bits), and its payload crosses to the reference's layout and
back (``bridge._payload_to_reference``, ``page_data_from_reference``).
The paged pool refuses the ``ckr`` leaf with a ``ValueError`` in both
packages. The module builds batchers in both packages, so it runs under
``lean_cpu``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.serving.engine as jengine
import repro_torch.serving.engine as tengine
from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from _torch_parity import (MARGIN, assert_streams_match, capture_port,
                           capture_reference, capture_reference_host,
                           reference_steps, top2_margin)
from repro.configs.base import get_config as jget_config
from repro.models.model import get_model as jget_model
from repro.serving.batcher import ContinuousBatcher as JStacked
from repro.serving.batcher import PagedContinuousBatcher as JPaged
from repro.serving.batcher import make_batcher as jmake_batcher
from repro.serving.kvpool import PagePool as JPool
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models.model import get_model as tget_model
from repro_torch.serving import sampling
from repro_torch.serving.batcher import ContinuousBatcher as TStacked
from repro_torch.serving.batcher import PagedContinuousBatcher as TPaged
from repro_torch.serving.batcher import make_batcher
from repro_torch.serving.kvpool import PagePool as TPool
from repro_torch.serving.kvpool import raw_bits
from test_torch_per_request import _record_reference

pytestmark = pytest.mark.usefixtures("lean_cpu")

HEAD = "shared clinical preamble for the cohort under review. "
WORKLOAD = [
    (HEAD + "alpha " * 12, 8, 0),
    ("an unrelated billing request with no shared head", 8, 1),
    ("tiny", 5, None),
    (HEAD + "gamma " * 4, 6, 0),
]
KW = dict(num_slots=3, max_len=96)
EXACT_STATS = ("ticks", "admissions", "prefills", "prefill_dispatches",
               "device_dispatches", "tick_dispatches_max", "decode_steps",
               "decode_tokens", "queued_peak")
PAGED_STATS = ("prefix_tokens_skipped", "share_hits", "cow_copies",
               "prefill_chunk_tokens", "stalls", "preemptions")
DS, KIMI = "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"


def _weights(arch):
    jcfg = jget_config(arch).reduced()
    tcfg = tget_config(arch).reduced()
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), "float32")
    tparams = bridge.from_reference(tcfg, jax.device_get(jparams))
    return jcfg, tcfg, jmodel, jparams, tparams


@pytest.fixture(scope="module")
def ds(lean_cpu):
    return _weights(DS)


@pytest.fixture(scope="module")
def kimi(lean_cpu):
    return _weights(KIMI)


def _submit_all(jb, tb):
    for p, mn, tier in WORKLOAD:
        assert jb.submit(p, max_new_tokens=mn, trust_tier=tier) == \
            tb.submit(p, max_new_tokens=mn, trust_tier=tier)
    jdone, tdone = jb.run_until_done(), tb.run_until_done()
    assert sorted(jdone) == sorted(tdone) == list(range(len(WORKLOAD)))
    assert all(t is not None for t in tdone.values())


def _hold_host_integers(jb, tb):
    assert tb.work_clock == jb.work_clock
    stats = EXACT_STATS + (PAGED_STATS if hasattr(tb, "pool") else ())
    for key in stats:
        assert tb.stats[key] == jb.stats[key], key
    assert tb.request_log == jb.request_log
    assert tb.tier_work == jb.tier_work
    if hasattr(tb, "pool"):
        assert tb.dispatch_shapes == jb.dispatch_shapes
        assert tb.pool.telemetry() == jb.pool.telemetry()
        assert tb.pool.in_use() == 0 and tb.pool.check()


def _serve(jb, tb, steps=None):
    """Serve the workload on both; ``steps`` (the reference's jitted fused
    steps) for a fused paged pair, None for host-sampled batchers."""
    if steps is not None:
        jtok, jmargin = capture_reference(jb, steps)
    else:
        jtok, jmargin = capture_reference_host(jb)
    ttok = capture_port(tb)
    _submit_all(jb, tb)
    _hold_host_integers(jb, tb)
    diverged = assert_streams_match(jtok, jmargin, ttok)
    assert diverged <= len(jtok) // 2, "most streams must match in full"
    return ttok


@pytest.mark.parametrize("arch,stacked", [(DS, True), (KIMI, False)])
def test_auto_cache_is_the_references_manager(arch, stacked, request):
    jcfg, tcfg, _, jparams, tparams = request.getfixturevalue(
        "ds" if arch == DS else "kimi")
    jb = jmake_batcher(jcfg, cache="auto", params=jparams)
    tb = make_batcher(tcfg, cache="auto", params=tparams, device="cpu")
    if stacked:
        assert isinstance(jb, JStacked) and isinstance(tb, TStacked)
    else:
        assert isinstance(jb, JPaged) and isinstance(tb, TPaged)
        assert tb.fused and tb.prefill_mode == "chunked"


def test_deepseek_stacked_matches_reference(ds):
    """The stacked batcher: a full-mode MLA prefill per admission into a
    bf16 ``ckr`` row, then one absorbed decode over every slot at (B,)
    positions; the MLA and MoE blocks run once a layer a dispatch."""
    jcfg, tcfg, _, jparams, tparams = ds
    jb = JStacked(jcfg, params=jparams, **KW)
    tb = TStacked(tcfg, params=tparams, device="cpu", **KW)
    tmla.mla_apply.calls = tmoe.moe_apply.calls = 0
    _serve(jb, tb)
    dispatches = tb.stats["device_dispatches"]
    assert tmla.mla_apply.calls == tcfg.num_layers * dispatches
    assert tmoe.moe_apply.calls == (tcfg.num_layers
                                    - tcfg.first_dense_layers) * dispatches


def _record_keys(tb):
    """Record, per (rid, token index), the sample key each decode draw of
    the port used."""
    keys = {}
    sample_ready = tb._sample_ready

    def sampled(logits, ready):
        for si in ready:
            s = tb.slots[si]
            keys[s.request_id, len(s.carried) + len(s.generated)] = \
                s.sample_key
        return sample_ready(logits, ready)

    tb._sample_ready = sampled
    return keys


def test_deepseek_stacked_sampled_matches_reference(ds):
    jcfg, tcfg, jmodel, jparams, tparams = ds
    t = 0.9
    jb = JStacked(jcfg, params=jparams, temperature=t, **KW)
    tb = TStacked(tcfg, params=tparams, device="cpu", temperature=t, **KW)
    jtok, jmargin = capture_reference_host(jb)
    ttok = capture_port(tb)
    keys = _record_keys(tb)
    _submit_all(jb, tb)
    _hold_host_integers(jb, tb)
    assert_streams_match({r: s[:1] for r, s in jtok.items()}, jmargin,
                         {r: s[:1] for r, s in ttok.items()})
    # the reference's logits behind each of the port's sampled tokens
    prefill = jax.jit(lambda p, c, tok: jmodel.forward(p, tokens=tok,
                                                       cache=c)[1])
    decode = jax.jit(lambda p, c, tok, pos: jmodel.forward(
        p, tokens=tok, mode="decode", cache=c, pos=pos)[:2])
    checked = near = 0
    for rid, stream in ttok.items():
        ids = tb.request_log[rid]["prompt_tokens"]
        prompt = tb.tok.encode(WORKLOAD[rid][0])[:ids]
        cache = prefill(jparams, jmodel.init_cache(1, KW["max_len"]),
                        np.asarray([prompt], np.int32))
        for k in range(1, len(stream)):
            lg, cache = decode(jparams, cache,
                               np.asarray([[stream[k - 1]]], np.int32),
                               np.int32(len(prompt) + k - 1))
            scores = sampling.perturbed_scores(
                torch.tensor(np.asarray(lg[:, 0], np.float32)),
                torch.tensor([keys[rid, k]], dtype=torch.int64), t)[0]
            if int(scores.argmax()) != stream[k]:
                assert top2_margin(scores.numpy()) <= MARGIN, (rid, k)
                near += 1
            checked += 1
    assert checked >= 20 and near <= 1


def test_deepseek_per_request_server_matches_reference(ds):
    """``LocalModelServer.generate``: one full-mode prefill of a padded
    batch into a bf16 ``ckr`` cache, then absorbed decode at one shared
    scalar position (ROADMAP R5's padding reproduced as is)."""
    jcfg, tcfg, _, jparams, tparams = ds
    js = jengine.LocalModelServer(jcfg, params=jparams, max_len=96)
    ts = tengine.LocalModelServer(tcfg, params=tparams, max_len=96,
                                  device="cpu")
    margins = _record_reference(js)
    prompts = [WORKLOAD[0][0], WORKLOAD[1][0]]
    _, jtoks = js.generate(prompts, max_new_tokens=6)
    _, ttoks = ts.generate(prompts, max_new_tokens=6)
    assert ttoks.shape == jtoks.shape == (2, 6)
    assert_streams_match(
        {r: [int(t) for t in jtoks[r]] for r in range(2)}, margins,
        {r: [int(t) for t in ttoks[r]] for r in range(2)})


def test_kimi_main_path_matches_reference(kimi):
    """kimi on the fused chunked paged batcher: K2 prefill chunks and K1
    decode (their plain versions here) under the MoE block, padded rows
    included."""
    jcfg, tcfg, jmodel, jparams, tparams = kimi
    jb = JPaged(jcfg, params=jparams, page_size=16, **KW)
    tb = TPaged(tcfg, params=tparams, device="cpu", page_size=16, **KW)
    tmoe.moe_apply.calls = 0
    _serve(jb, tb, reference_steps(jmodel))
    assert tmoe.moe_apply.calls == tb.stats["device_dispatches"]


def test_paged_pool_refuses_the_latent_cache(ds):
    """The paged pool takes attention K/V only: a ``ckr`` leaf is refused
    with a ``ValueError`` by both pools and both paged batchers."""
    jcfg, tcfg, jmodel, jparams, tparams = ds
    with pytest.raises(ValueError, match="ckr"):
        JPool(jmodel, max_len=96, page_size=16, num_pages=8)
    with pytest.raises(ValueError, match="ckr"):
        TPool(tget_model(tcfg), max_len=96, page_size=16, num_pages=8,
              device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        JPaged(jcfg, params=jparams, **KW)
    with pytest.raises(ValueError, match="stacked"):
        TPaged(tcfg, params=tparams, device="cpu", **KW)


PROMPTS = ["a somewhat longer request that spans multiple pages here",
           "short one"]


def _row_bits(b, si):
    return [raw_bits(layer["ckr"][si]).clone() for layer in b._cache]


def test_deepseek_slot_freezes_and_thaws_bitexact(ds):
    """A request frozen after every k ticks and thawed on a fresh stacked
    batcher: the ticket carries the slot's ``ckr`` rows as raw bits, the
    destination's row holds them bit for bit after the import, and the
    stream equals the undisturbed one."""
    _, tcfg, _, _, tparams = ds

    def make():
        return TStacked(tcfg, params=tparams, num_slots=2, max_len=96,
                        device="cpu")

    b0 = make()
    rids0 = [b0.submit(p, max_new_tokens=5, trust_tier=2) for p in PROMPTS]
    done0 = b0.run_until_done()
    base = [done0[r] for r in rids0]
    k, imports = 0, 0
    while True:
        a, b = make(), make()
        rids = [a.submit(p, max_new_tokens=5, trust_tier=2) for p in PROMPTS]
        for _ in range(k):
            a.tick()
        moved = {}
        for rid in rids:
            if rid in a.finished:
                continue
            si = next((i for i, s in enumerate(a.slots)
                       if s.active and s.request_id == rid), None)
            rows = _row_bits(a, si) if si is not None else None
            t = a.freeze_request(rid)
            if rows is not None:
                assert len(t.dense) == tcfg.num_layers
                for d, r in zip(t.dense, rows):
                    assert np.array_equal(d, r.numpy())
            nr = b.submit_ticket(t)
            moved[rid] = nr
            if rows is not None:
                b._admit()            # the thaw alone, before any decode
                dst = next(i for i, s in enumerate(b.slots)
                           if s.request_id == nr)
                for got, want in zip(_row_bits(b, dst), rows):
                    assert torch.equal(got, want)
                imports += 1
        a.run_until_done()
        b.run_until_done()
        out = [b.finished[moved[r]] if r in moved else a.finished[r]
               for r in rids]
        assert out == base, f"stream diverged at boundary k={k}"
        if not moved:
            break
        k += 1
    assert k > 2 and imports > 0


def test_dense_payload_crosses_to_the_reference_layout(ds):
    """The same request frozen after the same ticks by the reference's
    and the port's stacked batchers: the port's payload in the
    reference's leaf order (``bridge._payload_to_reference``) has the
    reference's shapes and dtypes and its values within one bf16 ulp or
    1e-4 (the migration tests' rule: latents computed by two frameworks
    round to bf16 from fp32 values ~1e-6 apart); the reference's payload
    carried back (``page_data_from_reference``) thaws into the port by
    import and serves on."""
    jcfg, tcfg, jmodel, jparams, tparams = ds
    kw = dict(num_slots=2, max_len=96)
    jb = JStacked(jcfg, params=jparams, **kw)
    tb = TStacked(tcfg, params=tparams, device="cpu", **kw)
    for b in (jb, tb):
        b.submit(PROMPTS[0], max_new_tokens=6, trust_tier=2)
        for _ in range(3):
            b.tick()
    jt, tt = jb.freeze_request(0), tb.freeze_request(0)
    for f in ("prompt", "prompt_ids", "generated", "max_new", "tier",
              "kv_tokens", "max_len", "phase"):
        assert getattr(tt, f) == getattr(jt, f), f
    like = jax.tree.map(np.asarray,
                        jmodel.init_cache(1, kw["max_len"]))
    port_as_ref = bridge._payload_to_reference(tcfg, tt.dense, like)
    assert len(port_as_ref) == len(jt.dense)
    for got, want in zip(port_as_ref, jt.dense):
        assert got.shape == want.shape and got.dtype == want.dtype
        a, b = got.astype(np.float32), np.asarray(want).astype(np.float32)
        assert np.all(np.abs(a - b) <= np.maximum(2.0 ** -7 * np.abs(b),
                                                  1e-4))
        assert (a != b).mean() <= 0.02
    back = bridge.page_data_from_reference(tcfg, port_as_ref, like)
    assert [a.reshape(d.shape).tobytes() for a, d in zip(back, tt.dense)] \
        == [d.tobytes() for d in tt.dense]
    ref_in_port = [np.array(a.reshape(d.shape)) for a, d in zip(
        bridge.page_data_from_reference(tcfg, jt.dense, like), tt.dense)]
    dst = TStacked(tcfg, params=tparams, device="cpu", **kw)
    rid = dst.submit_ticket(dataclasses.replace(tt, dense=ref_in_port))
    text = dst.run_until_done()[rid]
    assert text is not None and dst.migration_stats["imports"] == 1
