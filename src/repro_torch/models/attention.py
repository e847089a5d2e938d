"""GQA attention: full-prompt prefill, decode against a dense cache, and
chunked prefill and decode against the paged KV pool.

Port of ``repro/models/attention.py``: ``mode="full"`` (a whole prompt,
optionally written into a dense ``{"k", "v"}`` cache), ``mode="chunk"``
(page-aligned prefill chunk runs into the paged pool) and
``mode="decode"`` against either cache. Attention itself goes through the
hand-written kernels in ``repro_torch.kernels``, which launch on CUDA
tensors and take their plain version on CPU tensors; ``mode="full"``
always takes ``flash_attention``, which computes the function the
reference's ``attend_naive``/``attend_blocked``/Pallas choice computes at
every length. Caches and pool pages are updated IN PLACE (the reference
returns new, donated arrays), each layer writing its fresh K/V before it
attends, exactly as the reference orders it.

A local-attention ``window`` (recurrentgemma-9b) masks the prefill to keys
``t-window+1..t`` and gives the dense cache ``min(window, max_len)`` slots,
a ring buffer that decode writes at ``pos % W``. A prompt longer than the
ring keeps its last ``W`` tokens in order, slot ``j`` holding token
``S-W+j``, as the reference does; the reference's first decode after such
a prompt then overwrites slot ``S % W``, not the oldest token's slot 0,
and the port reproduces that too (ROADMAP R6). The paged modes take no
window, as in the reference.

A dense cache may be fp8 (``float8_e4m3fn`` or ``float8_e5m2``, from
``Model.init_cache``): it then carries fp32 ``k_scale``/``v_scale`` (B, W,
Hkv) beside ``k``/``v``, K/V are quantized on write with a
per-token-per-head scale (``_fp8_quantize``), and decode dequantizes the
whole cache to fp32 before ``decode_attention``, as the reference does.
Prefill attends the unquantized K/V.

A prefix-LM config (paligemma-3b) makes its first ``num_prefix_tokens``
keys visible to every query in ``mode="full"`` only, as the reference
does (``repro/models/attention.py:217``): its chunk mode and both decode
modes stay causal, so the paged chunked path attends the prefix causally
while the stacked, per-request and ``prefill="full"`` paths attend it both
ways (ROADMAP R8), and a full-mode re-prefill of a generated stream that
is still inside the prefix attends those tokens both ways too (R9). The
port reproduces both, path for path.

Under a mesh (``sharding.axis_rules``) whose model axis kv_heads does
not divide, the dense cache is sequence-sharded where the model axis
divides its slots (``attn_cache_spec``'s ``kv_seq`` axis; the cache a
``decode_sharded.SeqSplitCache``): each rank holds its slot range, a
full prefill writes only that range of the prompt's K/V (the reference
writes a global array and lets XLA slice it), and decode runs
``decode_sharded.seq_sharded_decode`` (plain torch ops and three
all-reduces, no K3), as the reference's decode branch does. An fp8 cache
keeps the seq-sharded layout but, as in the reference (which skips the
seq-sharded decode for a quantized cache), decodes over the whole cache:
the owning rank writes the token and its scales, every rank dequantizes
its slots, the slots are gathered (``decode_sharded.gather_seq``) and
K3 runs on the global fp32 cache. Otherwise (a plain dict: the model
axis divides the kv heads, or does not divide the slots, max_len or a
ring's W) a rank's cache holds every slot and its kv heads, a full
prefill writes every slot, and it decodes through K3 as without a mesh.

Tensor parallel over "model" (``sharding.LOCAL_RULES``): a rank holds
its columns of ``wq``, ``wk`` and ``wv`` and its rows of ``wo`` as the
rules split them (by the flattened ``heads * head_dim`` dim). Where the
model axis divides the heads, q (and k, v where it divides the kv heads
too) hold the rank's heads and K1-K4 run at the local head counts;
where it does not, the projection's columns are gathered over "model"
(``layers.split_heads``) and every head is computed. ``wo`` is
row-parallel, summed over "model" after it (``layers.row_parallel``).
Where q heads are split and kv heads whole, each local q head reads its
own kv head from the whole K/V (``_kv_for_q``: one shared kv head where
the local heads lie inside one group, the rows repeated per q head where
they straddle groups) in full mode and in a decode against a whole dense
cache, at the local head count through K4 and K3; a decode against the
sequence-sharded cache gathers q's heads over "model" before the region
and keeps the rank's heads after the merge. qk_norm acts per head, so
its weights are read by split work (``sharding.column_in``). The paged
pool holds the rank's kv heads, or every kv head where the model axis
does not divide them (``kvpool.PagePool``); with q split over whole kv
heads, chunk and decode gather q's heads over "model", run K2 and K1 at
every head, and keep the rank's heads of the output.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.models.decode_sharded import (SeqSplitCache, check_whole,
                                               gather_seq, model_shards,
                                               seq_shard_axes,
                                               seq_sharded_decode,
                                               slot_and_fill, use_seq_sharded,
                                               write_owned, write_prompt)
from repro_torch.models.layers import (PSpec, apply_rope, rms_norm,
                                       row_parallel, split_heads)
from repro_torch.sharding import (column_in, current_mesh, model_gather,
                                  model_offset)


def _fp8_quantize(x, dt):
    """Per-token-per-head symmetric quantization for fp8 KV caches: the
    head-dim amax maps onto the dtype's max normal, keeping small K/V
    values out of the fp8 subnormal range. Returns (quantized, scale)."""
    fmax = float(torch.finfo(dt).max)
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # divide by a tensor: on the card PyTorch divides by a Python scalar as
    # a product with its reciprocal, which can put the scale one ulp off
    # the reference's true division (and off the CPU's)
    s = torch.clamp(amax / torch.full_like(amax, fmax), min=1e-12)
    return (xf / s[..., None]).to(dt), s


def attend_decode_paged(q, k_pages, v_pages, block_table, valid_lens, scale):
    """One-token decode against a paged pool: q (B,1,H,D); pages
    (P,page_size,Hkv,D); block_table (B,N) int32; valid_lens (B,) int32."""
    o = paged_decode_attention(q[:, 0].contiguous(), k_pages, v_pages,
                               block_table, valid_lens, scale)
    return o[:, None]


def attend_chunk_paged(q, k_pages, v_pages, block_table, start_pos, scale):
    """Page-aligned prefill chunk against the paged pool: q (B,T,H,D) —
    T fresh tokens already scattered into the pool — attends causally over
    everything the block table covers; start_pos (B,) int32 absolute
    position of the chunk's first token."""
    return chunked_prefill_attention(q.contiguous(), k_pages, v_pages,
                                     block_table, start_pos, scale)


def attend_decode(q, k_cache, v_cache, valid_len, scale):
    """One-token decode against a dense cache: q (B,1,H,D); caches
    (B,S,Hkv,D); valid_len (B,) int32 filled slots per row."""
    return decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                            valid_len, scale)[:, None]


def _kv_for_q(t, H, Hkv, Hl):
    """K or V (B, S, Hkv, D), every kv head, for this rank's ``Hl`` of
    ``H`` q heads where the model axis divides the q heads but not the
    kv heads. Where the local q heads lie inside one group (G = H / Hkv a
    multiple of Hl) they read its kv head, ``q0 // G``; where they
    straddle groups, each q head's own, ``(q0 + i) // G``, the rows
    repeated per q head (one kv head a q head)."""
    G = H // Hkv
    q0 = model_offset(Hl)
    if G % Hl == 0:
        kv = q0 // G
        return t[:, :, kv:kv + 1].contiguous()
    idx = torch.div(q0 + torch.arange(Hl, device=t.device), G,
                    rounding_mode="floor")
    return t.index_select(2, idx)


def _decode_seq_sharded(cfg, q, k, v, positions, cache, window, scale):
    """Decode one token against this rank's slots of a seq-sharded dense
    cache (updated in place): q (B, 1, local q heads, D), k/v (B, 1,
    Hkv, D) before RoPE. A plain cache takes ``seq_sharded_decode``; an
    fp8 one is written by its owning rank, gathered as fp32 and attended
    by K3 whole, as the reference decodes a quantized cache without the
    seq-sharded path. Split q heads are gathered over "model" first, and
    the rank's heads of the output kept."""
    B, Hl = q.shape[0], q.shape[2]
    posb = (torch.zeros(B, dtype=torch.int32, device=q.device)
            + positions).to(torch.int32)
    q = apply_rope(q, posb[:, None], cfg.rope_theta)
    k = apply_rope(k, posb[:, None], cfg.rope_theta)
    if Hl != cfg.num_heads:
        q = model_gather(q, 2)
    o = _decode_seq_sharded_all(cfg, q, k, v, posb, cache, window, scale)
    if Hl != cfg.num_heads:
        o = o.narrow(2, model_offset(Hl), Hl)
    return o


def _decode_seq_sharded_all(cfg, q, k, v, posb, cache, window, scale):
    B = q.shape[0]
    if "k_scale" not in cache:
        _, _, o = seq_sharded_decode(cache["k"], cache["v"],
                                     k.to(cache["k"].dtype),
                                     v.to(cache["v"].dtype), q, posb,
                                     window, scale)
        return o
    group = current_mesh().get_group("model")
    rank, n = model_shards()
    slot, valid = slot_and_fill(posb, B, cache["k"].shape[1] * n, window,
                                q.device)
    for name, t in (("k", k), ("v", v)):
        td, ts = _fp8_quantize(t[:, 0], cache[name].dtype)
        write_owned(cache[name], td, slot, rank)
        write_owned(cache[name + "_scale"], ts, slot, rank)
    k_att = gather_seq(cache["k"].float() * cache["k_scale"][..., None],
                       group, rank, n)
    v_att = gather_seq(cache["v"].float() * cache["v_scale"][..., None],
                       group, rank, n)
    return attend_decode(q, k_att, v_att, valid.to(torch.int32), scale)


def _all_heads(q, gather):
    """q (B, T, Hl, D) with its heads gathered over "model" where
    ``gather`` (this rank's q heads over a pool of every kv head)."""
    return model_gather(q, 2) if gather else q


def _local_heads(o, gathered, Hl):
    """This rank's ``Hl`` heads of an output ``_all_heads`` gathered."""
    return o.narrow(2, model_offset(Hl), Hl) if gathered else o


# ------------------------------------------------------------------- block

def attn_table(cfg):
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t = {
        "ln": PSpec((d,), (None,), "zeros"),
        "wq": PSpec((d, H * hd), (None, "heads")),
        "wk": PSpec((d, Hkv * hd), (None, "kv_heads")),
        "wv": PSpec((d, Hkv * hd), (None, "kv_heads")),
        "wo": PSpec((H * hd, d), ("heads", None)),
    }
    if cfg.qk_norm:
        t["q_norm"] = PSpec((hd,), (None,), "zeros")
        t["k_norm"] = PSpec((hd,), (None,), "zeros")
    return t


def attn_cache_spec(cfg, batch, max_len, window=None):
    """{name: (global shape, logical axes)} of this block's dense decode
    cache: ``max_len`` slots, or ``min(window, max_len)`` for a windowed
    layer. Mesh-aware: when kv_heads don't divide the model axis, the
    sequence dim is sharded instead (the seq-sharded decode), where the
    model axis divides the slots; else the cache stays whole."""
    S = min(window, max_len) if window else max_len
    sh = (batch, S, cfg.num_kv_heads, cfg.head_dim)
    if use_seq_sharded(cfg.num_kv_heads, S):
        ax = seq_shard_axes()
    else:
        ax = ("batch", None, "kv_heads", None)
    return {"k": (sh, ax), "v": (sh, ax)}


def attn_apply(cfg, p, x, positions, *, mode, cache=None, window=None,
               block_table=None, dst_page=None):
    """mode 'full' (x (B, S, d), positions (S,) = 0..S-1; ``cache`` None
    or this layer's dense ``{"k", "v"}`` (B, W, Hkv, D), whose first S
    slots take the prompt's K/V, or, when W < S (a windowed ring), the
    last W tokens' K/V), 'chunk' (x (B, C*page_size, d),
    positions (B, T) absolute positions of each row's tokens, ``dst_page``
    (B, C) page ids the rows' K/V lands on — the scratch page masks the
    write) or 'decode' (x (B, 1, d), positions a scalar or (B,)
    per-sequence positions). A decode ``cache`` is either dense
    ``{"k", "v"}`` (the token lands in slot min(pos, W-1), or pos % W with
    a ``window``) or this layer's
    ``k_pages``/``v_pages`` (P, page_size, Hkv, D) with ``block_table``
    (B, N) int32; caches are updated in place. Weights are (d_in, d_out),
    as the reference stores them: ``h @ W``. Returns (x + attn_out,
    cache)."""
    B = x.shape[0]
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = hd ** -0.5
    h = rms_norm(x, p["ln"])
    # the projections' columns as the rules split them: whole heads
    # (this rank's), or gathered where a split falls mid-head
    hs = column_in(h)
    q = split_heads(torch.matmul(
        h if p["wq"].shape[1] == H * hd else hs, p["wq"]), H, hd)
    hk = h if p["wk"].shape[1] == Hkv * hd else hs
    k = split_heads(torch.matmul(hk, p["wk"]), Hkv, hd)
    v = split_heads(torch.matmul(hk, p["wv"]), Hkv, hd)
    Hl, Kl = q.shape[2], k.shape[2]
    q_split, kv_split = Hl != H, Kl != Hkv
    if cfg.qk_norm:
        q = rms_norm(q, column_in(p["q_norm"]) if q_split else p["q_norm"])
        k = rms_norm(k, column_in(p["k_norm"]) if kv_split
                     else p["k_norm"])
    # split q heads over replicated kv heads: each reads its global one
    kv_whole = q_split and not kv_split
    seq_split = isinstance(cache, SeqSplitCache)
    if mode == "full":       # a whole prompt, positions 0..S-1
        S = x.shape[1]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        prefix_len = cfg.num_prefix_tokens if cfg.prefix_lm else 0
        k_att, v_att = k, v
        if kv_whole:
            k_att = _kv_for_q(column_in(k), H, Hkv, Hl)
            v_att = _kv_for_q(column_in(v), H, Hkv, Hl)
        o = flash_attention(q, k_att, v_att, scale, window=window,
                            prefix_len=prefix_len)
        if cache is not None:
            W = cache["k"].shape[1]
            if not seq_split:
                check_whole(Hkv, W)
            new = {}
            if "k_scale" in cache:       # fp8 cache: quantize on write
                new["k"], new["k_scale"] = _fp8_quantize(k, cache["k"].dtype)
                new["v"], new["v_scale"] = _fp8_quantize(v, cache["v"].dtype)
            else:
                new["k"], new["v"] = k, v
            for name, val in new.items():
                if seq_split:            # this rank's slots only
                    write_prompt(cache[name], val, *model_shards())
                elif W >= S:
                    cache[name][:, :S] = val.to(cache[name].dtype)
                else:        # windowed ring: keep the last W tokens
                    cache[name].copy_(val[:, -W:])
    elif mode == "decode" and seq_split:
        o = _decode_seq_sharded(cfg, q, k, v, positions, cache, window,
                                scale)
    elif mode == "decode" and "k" in cache:   # one token, dense cache
        W = cache["k"].shape[1]
        check_whole(Hkv, W)
        posb = (torch.zeros(B, dtype=torch.int32, device=x.device)
                + positions).to(torch.int32)       # scalar or (B,)
        q = apply_rope(q, posb[:, None], cfg.rope_theta)
        k = apply_rope(k, posb[:, None], cfg.rope_theta)
        rows = torch.arange(B, device=x.device)
        slot = (posb % W if window else torch.clamp(posb, max=W - 1)).long()
        if "k_scale" in cache:           # fp8 cache: quantize on write
            for n, t in (("k", k), ("v", v)):
                td, ts = _fp8_quantize(t[:, 0], cache[n].dtype)
                cache[n][rows, slot] = td
                cache[n + "_scale"][rows, slot] = ts
            # the decode kernel reads the dequantized fp32 cache
            k_att = cache["k"].float() * cache["k_scale"][..., None]
            v_att = cache["v"].float() * cache["v_scale"][..., None]
        else:
            cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
            k_att, v_att = cache["k"], cache["v"]
        if kv_whole:
            k_att = _kv_for_q(k_att, H, Hkv, Hl)
            v_att = _kv_for_q(v_att, H, Hkv, Hl)
        o = attend_decode(q, k_att, v_att, torch.clamp(posb + 1, max=W),
                          scale)
    elif mode == "chunk":    # page-aligned prefill chunks into the paged pool
        kp, vp = cache["k_pages"], cache["v_pages"]
        ps = kp.shape[1]
        S = x.shape[1]
        assert S % ps == 0, (
            f"chunk mode is whole pool pages, got {S} tokens "
            f"(page_size {ps})")
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        # write the fresh chunks' K/V onto their pages BEFORE attending, so
        # each chunk attends to itself — and to pages other rows of the same
        # dispatch wrote at this layer — through the block table like any
        # other context. dst entries equal to the scratch page (0) mask the
        # write for prefix-shared pages and padding; several rows may land
        # there at once, in an order CUDA leaves open, which is harmless
        # because causal masking keeps the scratch page out of every real
        # row. Real pages are private to one row, so their writes are exact.
        C = S // ps
        dst = (dst_page if dst_page.dim() == 2 else dst_page[None]).reshape(-1)
        kp.index_copy_(0, dst.long(),
                       k.to(kp.dtype).reshape(B * C, ps, Kl, hd))
        vp.index_copy_(0, dst.long(),
                       v.to(vp.dtype).reshape(B * C, ps, Kl, hd))
        start = positions[:, 0].to(torch.int32).contiguous()
        o = _local_heads(attend_chunk_paged(_all_heads(q, kv_whole), kp, vp,
                                            block_table, start, scale),
                         kv_whole, Hl)
    elif mode == "decode":   # one token per sequence against the paged pool
        kp, vp = cache["k_pages"], cache["v_pages"]
        ps = kp.shape[1]
        posb = (torch.zeros(B, dtype=torch.int32, device=x.device)
                + positions).to(torch.int32)       # scalar or (B,)
        q = apply_rope(q, posb[:, None], cfg.rope_theta)
        k = apply_rope(k, posb[:, None], cfg.rope_theta)
        # scatter the new token into each sequence's current page; idle
        # slots carry all-zero block tables and land on the scratch page.
        # The page column is clamped to the table, which is the reference's
        # (XLA's) out-of-range gather rule, so no index can fault
        N = block_table.shape[1]
        rows = torch.arange(B, device=x.device)
        col = torch.clamp(posb // ps, max=N - 1).long()
        pi = block_table[rows, col].long()
        off = (posb % ps).long()
        kp[pi, off] = k[:, 0].to(kp.dtype)
        vp[pi, off] = v[:, 0].to(vp.dtype)
        o = _local_heads(attend_decode_paged(_all_heads(q, kv_whole), kp,
                                             vp, block_table, posb + 1,
                                             scale), kv_whole, Hl)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    y = row_parallel(o.reshape(B, o.shape[1], Hl * hd), p["wo"], q_split)
    return x + y, cache
