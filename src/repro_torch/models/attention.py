"""GQA attention against the paged KV pool: chunked prefill and decode.

Port of the paged modes of ``repro/models/attention.py``: ``mode="chunk"``
(page-aligned prefill chunk runs) and paged ``mode="decode"``. Attention
itself goes through the hand-written kernels in ``repro_torch.kernels``,
which launch on CUDA tensors and take their plain version on CPU tensors.
The pool pages are updated IN PLACE (the reference returns new, donated
arrays): each layer scatters its fresh K/V onto its pages before it
gathers, exactly as the reference orders it.

Not ported yet: ``mode="full"``, dense decode caches, fp8 KV and windowed
attention.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.models.layers import PSpec, apply_rope, rms_norm


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


def attn_apply(cfg, p, x, positions, *, mode, cache, block_table,
               dst_page=None):
    """mode 'chunk' (x (B, C*page_size, d), positions (B, T) absolute
    positions of each row's tokens, ``dst_page`` (B, C) page ids the rows'
    K/V lands on — the scratch page masks the write) or 'decode' (x
    (B, 1, d), positions (B,) per-sequence positions). ``cache`` holds this
    layer's ``k_pages``/``v_pages`` (P, page_size, Hkv, D), updated in
    place; ``block_table`` (B, N) int32. Weights are (d_in, d_out), as the
    reference stores them: ``h @ W``. Returns (x + attn_out, cache)."""
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
    kp, vp = cache["k_pages"], cache["v_pages"]
    ps = kp.shape[1]
    if mode == "chunk":      # page-aligned prefill chunks into the paged pool
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
        raise NotImplementedError(
            f"attention mode {mode!r} is not ported yet (paged 'chunk' and "
            f"'decode' only)")
    y = torch.matmul(o.reshape(B, o.shape[1], H * hd), p["wo"])
    return x + y, cache
