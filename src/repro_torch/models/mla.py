"""Multi-head Latent Attention (DeepSeek-V2) [arXiv:2405.04434].

Port of ``repro/models/mla.py``. KV is compressed to a rank-
``kv_lora_rank`` latent ``c`` plus a shared (MQA-style) RoPE key. The
decode cache stores only ``ckr = concat(c, k_rope)``: (512+64) values a
token instead of 2*H*128.

Modes:
* ``full``: q/k at D nope+rope (192 at full width), v at D ``v_head_dim``
  (128), the latent through ``kv_ln``, the RoPE key broadcast over the
  heads; causal attention in fp32 (the reference's ``attend_naive``, or
  ``attend_blocked`` above 1024 tokens: the same function, which the
  port computes in one pass at every length). With a cache, the prompt's
  ``ckr``, cast to the cache's dtype, fills slots 0..S-1.
* decode ``absorbed`` (the default): W_uk is folded into the query and
  W_uv applied after the attention, so scores and outputs are computed
  in latent space, MQA over the 576-wide latent, the query in fp32.
* decode ``naive``: K/V re-expanded from the latent every step (the
  numerical oracle).

Decode writes the new token's ``ckr`` into the cache BEFORE attending, so
the token attends to its own latent as the cache's dtype rounds it, as
the reference does. ``pos`` is a scalar or (B,) per-row positions (the
port's stacked batcher decodes every slot in one call; the reference
``vmap``s its step over slots with a scalar ``pos``): row b writes slot
``min(pos_b, S-1)`` (the reference's ``dynamic_update_slice`` clamp) and
attends slots ``< pos_b + 1``. An fp8 cache is a plain cast, with no
scale: the reference adds scales only beside attention's ``k``/``v``.

The reference computes all of this with XLA einsums and no Pallas
kernel, and so does the port with torch ops: the port's K3/K4 take one
D up to 256 for q, k and v, and MLA needs 192/128 and 576/512.

Under a mesh with a model axis of more than one rank the latent cache
(which has no kv-head dim) is sequence-sharded (``mla_cache_spec``, a
``decode_sharded.SeqSplitCache``) where the model axis divides max_len:
a full prefill writes this rank's slot range, and decode is the
absorbed query against ``decode_sharded.seq_sharded_decode`` with
``ckr`` as the keys and its first ``kv_lora_rank`` lanes as the values
(MQA over the latent), whatever ``decode_mode`` says, as the reference.
Where it does not divide max_len the cache stays whole on every rank
(a plain dict) and decodes as without a mesh, as the reference's.

Tensor parallel over "model" (``sharding.LOCAL_RULES``): where the
model axis divides the heads, ``wq``, ``w_uk``, ``w_uv`` and ``wo`` hold
this rank's heads (``wo`` row-parallel, summed over "model" after it);
``w_dkv``, ``w_krope`` and ``kv_ln`` are replicated, so the latent and
the RoPE key are whole on every rank and read by split work
(``sharding.column_in``). The seq-sharded decode gathers the absorbed
query's heads over "model" before the region and keeps the rank's heads
of the merged latent output. Where the rules split the heads' columns
mid-head (a model axis that divides ``H * (nd + rd)`` but not ``H``),
``wq``'s output and ``w_uk``/``w_uv`` are gathered over "model" and
every head is computed, as GSPMD reshards there; ``wo``'s rows stay the
rules' slice (``layers.row_parallel``).

``mla_apply`` counts its calls in ``mla_apply.calls``, as the kernel
wrappers count ``.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.models.decode_sharded import (SeqSplitCache, check_whole,
                                               model_shards, seq_shard_axes,
                                               seq_sharded_decode,
                                               use_seq_sharded, write_prompt)
from repro_torch.models.layers import (PSpec, apply_rope, rms_norm,
                                       row_parallel)
from repro_torch.sharding import (column_in, gather_out, model_gather,
                                  model_offset, model_ranks)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def mla_table(cfg):
    d, H = cfg.d_model, cfg.num_heads
    nd, rd, vd, r = (cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    return {
        "ln": PSpec((d,), (None,), "zeros"),
        "wq": PSpec((d, H * (nd + rd)), (None, "heads")),
        "w_dkv": PSpec((d, r), (None, None)),
        "w_krope": PSpec((d, rd), (None, None)),
        "kv_ln": PSpec((r,), (None,), "zeros"),
        "w_uk": PSpec((r, H * nd), (None, "heads")),
        "w_uv": PSpec((r, H * vd), (None, "heads")),
        "wo": PSpec((H * vd, d), ("heads", None)),
    }


def mla_cache_spec(cfg, batch, max_len, window=None):
    """{name: (global shape, logical axes)} of this block's dense decode
    cache: one latent of ``kv_lora_rank + rope_head_dim`` a slot, no
    kv-head dim, its slots sharded over the model axis under a mesh."""
    sh = (batch, max_len, 1, cfg.kv_lora_rank + cfg.rope_head_dim)
    if use_seq_sharded(0, max_len):  # latent cache has no kv-head dim
        return {"ckr": (sh, seq_shard_axes())}
    return {"ckr": (sh, ("batch", None, None, None))}


def _project_q(cfg, p, h, B):
    return _split_q(cfg, torch.matmul(h, p["wq"]), B)


def _split_q(cfg, q, B):
    """wq's output (B, S, heads * (nd + rd)) -> (q_nope, q_rope)."""
    nd, rd = cfg.nope_head_dim, cfg.rope_head_dim
    q = q.reshape(B, q.shape[1], -1, nd + rd)
    return q[..., :nd], q[..., nd:]


def _attend_causal(q, k, v, scale):
    """The reference's ``attend_naive`` at q_pos = k_pos = 0..S-1, one kv
    head per query head: q/k (B, S, H, D), v (B, S, H, Dv) -> (B, S, H,
    Dv) in q's dtype, softmax in fp32 with masked scores at NEG_INF."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    allowed = pos[None, :] <= pos[:, None]
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    pr = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", pr, v.float()).to(q.dtype)


def _absorbed_query(cfg, p, q_nope, q_rope, dtype):
    """q' = [q_nope @ W_uk^T, q_rope] (B, 1, H, r + rd) in ``dtype`` (H
    the heads this rank holds)."""
    nd, r = cfg.nope_head_dim, cfg.kv_lora_rank
    wuk = p["w_uk"].reshape(r, -1, nd)
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope.float(), wuk.float())
    return torch.cat([q_lat, q_rope.float()], dim=-1).to(dtype)


def _decode_seq_sharded(cfg, p, x, q_nope, q_rope, c, k_rope_t, ckr, posb,
                        scale):
    """The absorbed decode against this rank's slots of a seq-sharded
    latent cache (updated in place). Returns o (B, 1, H, v_head_dim) of
    this rank's H heads: split heads' queries are gathered over "model"
    for the region and the rank's heads of its output kept."""
    r, vd = cfg.kv_lora_rank, cfg.v_head_dim
    new = torch.cat([c, k_rope_t], dim=-1)[:, :, None, :].to(ckr.dtype)
    q_abs = _absorbed_query(cfg, p, q_nope, q_rope, x.dtype)
    H = q_abs.shape[2]
    if H != cfg.num_heads:
        q_abs = model_gather(q_abs, 2)
    _, _, o_lat = seq_sharded_decode(ckr, ckr[..., :r], new, new[..., :r],
                                     q_abs, posb, None, scale)
    if H != cfg.num_heads:
        o_lat = o_lat.narrow(2, model_offset(H), H)
    wuv = p["w_uv"].reshape(r, H, vd)
    return torch.einsum("bthr,rhv->bthv", o_lat.float(),
                        wuv.float()).to(x.dtype)


def mla_apply(cfg, p, x, positions, *, mode, cache=None,
              decode_mode="absorbed"):
    """mode 'full' (x (B, S, d), positions (S,) = 0..S-1; ``cache`` None
    or this layer's ``{"ckr"}`` (B, W, 1, r + rd), whose first S slots
    take the prompt's latent) or 'decode' (x (B, 1, d), positions a
    scalar or (B,) per-row positions, ``cache`` required; ``decode_mode``
    "absorbed" or "naive"). The cache is updated in place. Returns
    (x + attn_out, cache)."""
    mla_apply.calls += 1
    B = x.shape[0]
    nd, rd, vd, r = (cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    whole = p["wq"].shape[1] == cfg.num_heads * (nd + rd)
    # columns split mid-head: every head computed, from gathered columns
    mid = not whole and cfg.num_heads % model_ranks() != 0
    if mid:
        p = dict(p, w_uk=gather_out(p["w_uk"], -1),
                 w_uv=gather_out(p["w_uv"], -1))
    H = cfg.num_heads if mid else p["wq"].shape[1] // (nd + rd)
    split = H != cfg.num_heads             # this rank's whole heads
    tp = column_in if split else (lambda t: t)
    scale = (nd + rd) ** -0.5
    h = rms_norm(x, p["ln"])
    if mid:
        q_nope, q_rope = _split_q(cfg, gather_out(torch.matmul(
            column_in(h), p["wq"]), -1), B)
    else:
        q_nope, q_rope = _project_q(cfg, p, tp(h), B)
    c = rms_norm(torch.matmul(h, p["w_dkv"]), p["kv_ln"])
    k_rope_new = torch.matmul(h, p["w_krope"])

    if mode == "full":
        S = x.shape[1]
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        k_rope = apply_rope(k_rope_new[:, :, None, :], positions,
                            cfg.rope_theta)
        cs = tp(c)
        k_nope = torch.matmul(cs, p["w_uk"]).reshape(B, S, H, nd)
        v = torch.matmul(cs, p["w_uv"]).reshape(B, S, H, vd)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, tp(k_rope).expand(B, S, H, rd)], dim=-1)
        o = _attend_causal(q, k, v, scale)
        if cache is not None:
            ckr = torch.cat([c, k_rope[:, :, 0, :]], dim=-1)[:, :, None, :]
            if isinstance(cache, SeqSplitCache):      # this rank's slots only
                write_prompt(cache["ckr"], ckr, *model_shards())
            else:
                check_whole(0, cache["ckr"].shape[1])
                cache["ckr"][:, :S] = ckr.to(cache["ckr"].dtype)
    elif mode == "decode":
        posb = (torch.zeros(B, dtype=torch.int32, device=x.device)
                + positions).to(torch.int32)       # scalar or (B,)
        q_rope = apply_rope(q_rope, posb[:, None], cfg.rope_theta)
        k_rope_t = apply_rope(k_rope_new[:, :, None, :], posb[:, None],
                              cfg.rope_theta)[:, :, 0, :]
        ckr = cache["ckr"]
        S = ckr.shape[1]
        if isinstance(cache, SeqSplitCache):
            o = _decode_seq_sharded(cfg, p, x, q_nope, q_rope, c, k_rope_t,
                                    ckr, posb, scale)
            y = row_parallel(o.reshape(B, 1, H * vd), p["wo"], split)
            return x + y, cache
        check_whole(0, S)
        rows = torch.arange(B, device=x.device)
        slot = torch.clamp(posb, max=S - 1).long()
        ckr[rows, slot] = torch.cat([c, k_rope_t], dim=-1)[:, 0, None, :].to(
            ckr.dtype)
        valid = (torch.arange(S, device=x.device)[None, :]
                 < (posb.long() + 1)[:, None])[:, None, :]     # (B, 1, S)
        kk = ckr[:, :, 0, :].float()                           # (B, S, r+rd)
        if decode_mode == "absorbed":
            q_abs = _absorbed_query(cfg, p, q_nope, q_rope, x.dtype)
            s = torch.einsum("bthd,bsd->bhs", q_abs.float(), kk) * scale
            s = torch.where(valid, s, torch.full_like(s, NEG_INF))
            pr = torch.softmax(s, dim=-1)
            o_lat = torch.einsum("bhs,bsr->bhr", pr, kk[..., :r])[:, None]
            # absorbed output: o = (p . c) @ W_uv per head
            wuv = p["w_uv"].reshape(r, H, vd)
            o = torch.einsum("bthr,rhv->bthv", o_lat, wuv.float()).to(x.dtype)
        elif decode_mode == "naive":   # re-expansion: the oracle
            cc = kk[..., :r].to(h.dtype)
            k_nope = torch.matmul(cc, p["w_uk"]).reshape(B, S, H, nd)
            vv = torch.matmul(cc, p["w_uv"]).reshape(B, S, H, vd)
            kf = torch.cat([k_nope, kk[:, :, None, r:].to(h.dtype).expand(
                B, S, H, rd)], dim=-1)
            qf = torch.cat([q_nope, q_rope.to(h.dtype)], dim=-1)
            s = torch.einsum("bthd,bshd->bhs", qf.float(), kf.float()) * scale
            s = torch.where(valid, s, torch.full_like(s, NEG_INF))
            pr = torch.softmax(s, dim=-1)
            o = torch.einsum("bhs,bshv->bhv", pr,
                             vv.float())[:, None].to(x.dtype)
        else:
            raise ValueError(f"unknown MLA decode mode {decode_mode!r}")
    else:
        raise ValueError(f"MLA has no {mode!r} mode (it is not paged)")
    y = row_parallel(o.reshape(B, o.shape[1], H * vd), p["wo"], split)
    return x + y, cache


mla_apply.calls = 0
