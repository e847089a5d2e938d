"""Plain PyTorch versions of the attention kernels.

Each function keeps the signature and the tensor layouts of the kernel it
stands beside (``paged_attention.py``, ``chunked_prefill.py``,
``decode_attention.py``, ``flash_attention.py``); the math is
fp32 throughout with the finite ``NEG_INF`` mask, so a fully masked
position contributes an exact zero (``-inf - -inf`` would be NaN). The
wrappers call these for CPU tensors, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def flash_attention(q, k, v, scale, causal=True):
    """q (B, Sq, H, D); k/v (B, Sk, Hkv, D), H a multiple of Hkv. Causal
    masking is aligned at the top left: query t attends keys 0..t."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention(q, k, v, valid_len, scale):
    """q (B, H, D); k/v (B, S, Hkv, D); valid_len a scalar or a (B,)
    tensor: row b attends its first valid_len[b] cache slots."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    valid = torch.as_tensor(valid_len, device=q.device).to(
        torch.int64).reshape(-1, 1, 1, 1)
    slot = torch.arange(S, device=q.device)
    s = torch.where(slot[None, None, None, :] < valid, s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def _gather_pages(pages, block_table):
    """(P, ps, Hkv, D) pool + (B, N) table -> (B, N*ps, Hkv, D) fp32."""
    B, N = block_table.shape
    _, ps, Hkv, D = pages.shape
    return pages[block_table.long()].reshape(B, N * ps, Hkv, D).float()


def paged_decode_attention(q, k_pages, v_pages, block_table, valid_lens,
                           scale):
    """q (B, H, D); k_pages/v_pages (P, page_size, Hkv, D); block_table
    (B, N) int32; valid_lens (B,) int32. Gathers each sequence's K/V
    through its block table, masks positions >= valid_lens[b]."""
    B, H, D = q.shape
    Hkv = k_pages.shape[2]
    G = H // Hkv
    k = _gather_pages(k_pages, block_table)
    v = _gather_pages(v_pages, block_table)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k) * scale
    kpos = torch.arange(k.shape[1], device=q.device)
    valid = valid_lens.to(torch.int64).reshape(B)
    s = torch.where(kpos[None, None, None, :] < valid[:, None, None, None],
                    s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return o.reshape(B, H, D).to(q.dtype)


def chunked_prefill_attention(q, k_pages, v_pages, block_table, start_pos,
                              scale):
    """q (B, T, H, D) — T fresh tokens, token t of sequence b at absolute
    position ``start_pos[b] + t``; k_pages/v_pages (P, page_size, Hkv, D)
    already holding the chunk's own K/V; block_table (B, N) int32;
    start_pos (B,) int32. Causal over absolute positions."""
    B, T, H, D = q.shape
    Hkv = k_pages.shape[2]
    G = H // Hkv
    k = _gather_pages(k_pages, block_table)
    v = _gather_pages(v_pages, block_table)
    qg = q.reshape(B, T, Hkv, G, D).float()
    s = torch.einsum("bthgd,bkhd->bthgk", qg, k) * scale
    start = start_pos.to(torch.int64).reshape(B)
    qpos = start[:, None] + torch.arange(T, device=q.device)[None]   # (B, T)
    kpos = torch.arange(k.shape[1], device=q.device)                 # (K,)
    mask = kpos[None, None, :] <= qpos[:, :, None]                   # (B,T,K)
    s = torch.where(mask[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bthgk,bkhd->bthgd", p, v)
    return o.reshape(B, T, H, D).to(q.dtype)
