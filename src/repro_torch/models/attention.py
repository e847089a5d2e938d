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

Not ported yet: the sequence-sharded decode and prefix-LM masking.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.models.layers import PSpec, apply_rope, rms_norm


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
    """{name: shape} of this block's dense decode cache: ``max_len``
    slots, or ``min(window, max_len)`` for a windowed layer."""
    S = min(window, max_len) if window else max_len
    sh = (batch, S, cfg.num_kv_heads, cfg.head_dim)
    return {"k": sh, "v": sh}


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
    q = torch.matmul(h, p["wq"]).reshape(B, -1, H, hd)
    k = torch.matmul(h, p["wk"]).reshape(B, -1, Hkv, hd)
    v = torch.matmul(h, p["wv"]).reshape(B, -1, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if mode == "full":       # a whole prompt, positions 0..S-1
        S = x.shape[1]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = flash_attention(q, k, v, scale, window=window)
        if cache is not None:
            W = cache["k"].shape[1]
            new = {}
            if "k_scale" in cache:       # fp8 cache: quantize on write
                new["k"], new["k_scale"] = _fp8_quantize(k, cache["k"].dtype)
                new["v"], new["v_scale"] = _fp8_quantize(v, cache["v"].dtype)
            else:
                new["k"], new["v"] = k, v
            for name, val in new.items():
                if W >= S:
                    cache[name][:, :S] = val.to(cache[name].dtype)
                else:        # windowed ring: keep the last W tokens
                    cache[name].copy_(val[:, -W:])
    elif mode == "decode" and "k" in cache:   # one token, dense cache
        W = cache["k"].shape[1]
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
                       k.to(kp.dtype).reshape(B * C, ps, Hkv, hd))
        vp.index_copy_(0, dst.long(),
                       v.to(vp.dtype).reshape(B * C, ps, Hkv, hd))
        start = positions[:, 0].to(torch.int32).contiguous()
        o = attend_chunk_paged(q, kp, vp, block_table, start, scale)
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
        o = attend_decode_paged(q, kp, vp, block_table, posb + 1, scale)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    y = torch.matmul(o.reshape(B, o.shape[1], H * hd), p["wo"])
    return x + y, cache
