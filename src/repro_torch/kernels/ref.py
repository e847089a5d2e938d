"""Plain PyTorch versions of the hand-written kernels.

Each function keeps the signature and the tensor layouts of the kernel it
stands beside (``paged_attention.py``, ``chunked_prefill.py``,
``decode_attention.py``, ``flash_attention.py``, ``ssd.py``,
``rglru.py``; ``flash_attention_bwd``, ``ssd_chunk_bwd`` and
``rglru_scan_bwd`` beside the backward kernels of ``flash_attention.py``,
``ssd.py`` and ``rglru.py``, in closed form); the math is fp32
throughout. Attention
masks with the finite ``NEG_INF``, so a fully masked position contributes
an exact zero (``-inf - -inf`` would be NaN); the SSD decay masks with
``-inf`` before its exp, whose exact zero is what keeps the overflowing
upper triangle out. ``ssd_full`` and ``ssd_carry`` add the inter-chunk
recurrence (``models/ssm.py`` runs it). The wrappers call these for CPU
tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _prefill_mask(Sq, Sk, causal, window, prefix_len, device):
    """(Sq, Sk) bool: query t may attend key j (None: every pair)."""
    if not causal:
        return None
    kpos = torch.arange(Sk, device=device)[None, :]
    qpos = torch.arange(Sq, device=device)[:, None]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    if prefix_len:
        mask = mask | (kpos < prefix_len)
    return mask


def flash_attention(q, k, v, scale, causal=True, window=None,
                    prefix_len=0, return_lse=False):
    """q (B, Sq, H, D); k/v (B, Sk, Hkv, D), H a multiple of Hkv. Causal
    masking is aligned at the top left: query t attends keys 0..t, and
    with a local-attention ``window`` only keys t-window+1..t; keys below
    ``prefix_len`` (a prefix-LM's prefix) are visible to every query (the
    reference's ``allowed_mask``: (causal and window) or key < prefix).
    With ``return_lse`` also the log-sum-exp of each row's scaled scores,
    (B, Sq, H) fp32, which the backward reads."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    mask = _prefill_mask(Sq, Sk, causal, window, prefix_len, q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    o = o.reshape(B, Sq, H, D).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1)                    # (B, Hkv, G, Sq)
    return o, lse.permute(0, 3, 1, 2).reshape(B, Sq, H)


def flash_attention_bwd(q, k, v, o, lse, do, scale, causal=True,
                        window=None, prefix_len=0):
    """The gradients (dq, dk, dv) of ``flash_attention`` at its output
    ``o`` and log-sum-exp ``lse`` (B, Sq, H), for the output gradient
    ``do`` (B, Sq, H, D), from the formulas: P = exp(S - lse) (S the
    scaled scores, 0 where masked), dV = P^T dO, dP = dO V^T, D = sum_j
    softmax(S)_ij dP_ij, dS = P * (dP - D), dQ = scale dS K, dK = scale
    dS^T Q; dK and dV sum the G query heads of each kv head. Each in its
    input's dtype. D equals rowsum(dO * O) in exact arithmetic; taken
    from dP and the recomputed softmax, it is exactly dP_ii for a row
    that sees one key (a window of 1), whose dS, dQ and dK are then
    exactly 0, as the kernel's are. ``o`` is not read."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    dog = do.reshape(B, Sq, Hkv, G, D).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    lse_g = lse.reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)[..., None]
    p = torch.exp(s - lse_g)
    mask = _prefill_mask(Sq, Sk, causal, window, prefix_len, q.device)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    dsum = (torch.softmax(s, dim=-1) * dp).sum(-1, keepdim=True)
    ds = p * (dp - dsum)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def prefix_sum(v):
    """The inclusive prefix sum of v (B, nc, Q, H) along Q, one rounded
    add a row in row order, in v's dtype: K5's order (``csrc/ssd_chunk.cu``)
    and that of ``torch.cumsum`` along a non-innermost axis on the card.
    On the CPU ``torch.cumsum`` accumulates fp32 in fp64 and rounds each
    prefix once, another result: at |cum| ~ 8,000 one ulp is 5e-4 of a
    decay factor, and a train step's ``A_log`` and ``dt_bias`` gradients,
    sums with heavy cancellation, move with it
    (tests/test_torch_scan_bwd.py)."""
    if v.shape[2] == 0:
        return v.clone()
    acc = v[:, :, 0]
    rows = [acc]
    for i in range(1, v.shape[2]):
        acc = acc + v[:, :, i]
        rows.append(acc)
    return torch.stack(rows, dim=2)


def ssd_chunk(x, dt, a, B_, C_):
    """Per-chunk Mamba-2 SSD pieces (no inter-chunk recurrence).

    x (B, nc, Q, H, P), dt (B, nc, Q, H) fp32 post-softplus, a (H,) fp32
    negative, B_/C_ (B, nc, Q, N) fp32. Returns y_intra (B, nc, Q, H, P),
    state (B, nc, H, P, N), decay_total (B, nc, H) and cum (B, nc, Q, H),
    all fp32. ``cum`` is the inclusive prefix sum of dt * a along Q
    (``prefix_sum``: the kernel's order on every device); the decay
    matrix is masked BEFORE exp, so its upper triangle is an exact zero
    (exp of the positive upper triangle overflows)."""
    Q = x.shape[2]
    dA = dt * a                                          # (B, nc, Q, H)
    cum = prefix_sum(dA)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qt,Qs,H)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None], dec,
                              torch.full_like(dec, float("-inf"))))
    sc = torch.einsum("bcqn,bckn->bcqk", C_, B_)
    att = sc[..., None] * L * dt[:, :, None, :, :]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", att, x)
    total = cum[:, :, -1, :]
    w_s = torch.exp(total[:, :, None, :] - cum) * dt
    state = torch.einsum("bcqh,bcqn,bcqhp->bchpn", w_s, B_, x)
    return y_intra, state, torch.exp(total), cum


def ssd_chunk_bwd(x, dt, a, B_, C_, cum, gy, gstate, gdecay, gcum):
    """The gradients (gx, gdt, ga, gB, gC) of ``ssd_chunk(x, dt, a, B_,
    C_)``, whose ``cum`` output was ``cum``, for the gradients of its four
    outputs: gy (B, nc, Q, H, P), gstate (B, nc, H, P, N), gdecay (B, nc,
    H) and gcum (B, nc, Q, H); any of them None for zeros. All fp32.

    Per (batch, chunk, head), with s <= t: L_ts = exp(cum_t - cum_s), S =
    C.B^T (no head axis), M_ts = S_ts L_ts dt_s, y = M.x; w_s =
    exp(cum_{Q-1} - cum_s) dt_s, state = sum_s w_s x_s B_s^T, decay =
    exp(cum_{Q-1}). With G_ts = gy_t.x_s and R = G o M:
      gx_s   = sum_t M_ts gy_t + w_s gstate.B_s
      S_bar  = sum over heads of G o L o dt_s (summed BEFORE the products
               with B and C: one Q^2 N product a chunk, not one a head)
      gC     = S_bar.B;  gB = S_bar^T.C + sum_h w_s gstate^T.x_s
      wbar_s = x_s.gstate.B_s
      gdt_s  = sum_t G_ts S_ts L_ts + wbar_s exp(cum_{Q-1} - cum_s)
      gcum'  = gcum + rowsum(R) - colsum(R) - wbar o w, and at row Q-1
               also sum_s wbar_s w_s + gdecay decay
      gdA    = the reverse cumsum of gcum' along Q; gdt += gdA a, and
               ga = sum over (batch, chunk, row) of gdA dt.
    L is masked BEFORE its exp, as in the forward: the upper triangle's
    exp overflows, and inf * 0 would be NaN."""
    Q = x.shape[2]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qt,Qs,H)
    L = torch.exp(torch.where(tri[None, None, :, :, None], dec,
                              torch.full_like(dec, float("-inf"))))
    total = cum[:, :, -1, :]
    e = torch.exp(total[:, :, None, :] - cum)           # (B, nc, Q, H)
    w = e * dt
    gx = torch.zeros_like(x)
    gdt = torch.zeros_like(dt)
    gB, gC = torch.zeros_like(B_), torch.zeros_like(C_)
    gc = gcum.clone() if gcum is not None else torch.zeros_like(cum)
    if gy is not None:
        S = torch.einsum("bcqn,bckn->bcqk", C_, B_)
        LD = L * dt[:, :, None, :, :]                    # L_ts dt_s
        gx = torch.einsum("bcts,bctsh,bcthp->bcshp", S, LD, gy)
        G = torch.einsum("bcthp,bcshp->bctsh", gy, x)
        S_bar = (G * LD).sum(-1)                         # over the heads
        gC = torch.einsum("bcts,bcsn->bctn", S_bar, B_)
        gB = torch.einsum("bcts,bctn->bcsn", S_bar, C_)
        GSL = G * S[..., None] * L
        gdt = GSL.sum(2)
        R = GSL * dt[:, :, None, :, :]
        gc = gc + R.sum(3) - R.sum(2)
    if gstate is not None:
        V = torch.einsum("bchpn,bcsn->bcshp", gstate, B_)
        gx = gx + w[..., None] * V
        wbar = (x * V).sum(-1)                           # (B, nc, Q, H)
        gB = gB + torch.einsum("bcsh,bchpn,bcshp->bcsn", w, gstate, x)
        gdt = gdt + wbar * e
        gc = gc - wbar * w
        gc[:, :, -1] += (wbar * w).sum(2)
    if gdecay is not None:
        gc[:, :, -1] += gdecay * torch.exp(total)
    gdA = torch.flip(torch.cumsum(torch.flip(gc, (2,)), 2), (2,))
    gdt = gdt + gdA * a
    ga = (gdA * dt).sum((0, 1, 2))
    return gx, gdt, ga, gB, gC


def ssd_full(x, dt, a, B_, C_, chunk):
    """Full SSD = chunk pieces + inter-chunk scan: x (B, S, H, P) with S a
    multiple of min(chunk, S). Returns y (B, S, H, P) fp32."""
    Bsz, S, H, P = x.shape
    Q = min(chunk, S)
    assert S % Q == 0
    nc = S // Q
    y_intra, state, decay, cum = ssd_chunk(
        x.reshape(Bsz, nc, Q, H, P), dt.reshape(Bsz, nc, Q, H), a,
        B_.reshape(Bsz, nc, Q, -1), C_.reshape(Bsz, nc, Q, -1))
    h_prev, _ = ssd_carry(state, decay)
    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp",
                           C_.reshape(Bsz, nc, Q, -1), h_prev,
                           torch.exp(cum))
    return (y_intra + y_inter).reshape(Bsz, S, H, P)


def ssd_carry(state, decay):
    """The inter-chunk recurrence h_c = decay_c * h_{c-1} + state_c from
    h = 0: returns (h_prev (B, nc, H, P, N), the state entering each
    chunk, and h_final (B, H, P, N), the carry after the last chunk)."""
    h = torch.zeros_like(state[:, 0])
    prev = []
    for c in range(state.shape[1]):
        prev.append(h)
        h = decay[:, c, :, None, None] * h + state[:, c]
    return torch.stack(prev, dim=1), h


def rglru_scan(a, b, h0=None):
    """The RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t along axis 1,
    from h0 (B, C) or zeros: a, b (B, S, C) fp32 or bf16. Returns h
    (B, S, C) fp32. One step at a time, each a rounded multiply then a
    rounded add, as the kernel takes them."""
    dtype = torch.promote_types(a.dtype, torch.float32)   # bf16 -> fp32
    a, b = a.to(dtype), b.to(dtype)
    h = (h0.to(dtype) if h0 is not None
         else torch.zeros_like(a[:, 0]))
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd(a, h, h0, gh):
    """The gradients (ga, gb, gh0) of ``rglru_scan(a, b, h0)``, whose
    output was ``h`` (B, S, C) fp32, for its gradient ``gh`` (B, S, C):
    the reverse scan g_t = gh_t + a_{t+1} g_{t+1} from g_S = 0, each step
    a rounded multiply then a rounded add, as the kernel takes them; gb =
    g, ga_t = g_t h_{t-1} with h_{-1} = h0 (zeros where None), gh0 =
    a_0 g_0 (None where h0 is None). ga and gb come back in a's dtype
    (b's, which the forward requires to be the same), gh0 in h0's."""
    dtype = torch.promote_types(a.dtype, torch.float32)   # bf16 -> fp32
    af, gh = a.to(dtype), gh.to(dtype)
    g = torch.zeros_like(gh[:, 0])
    a_next = torch.zeros_like(g)
    gs = torch.empty_like(gh)
    for t in range(gh.shape[1] - 1, -1, -1):
        g = gh[:, t] + a_next * g
        gs[:, t] = g
        a_next = af[:, t]
    start = (h0.to(dtype) if h0 is not None else torch.zeros_like(g))[:, None]
    ga = gs * torch.cat([start, h.to(dtype)], dim=1)[:, :-1]
    gh0 = (a_next * g).to(h0.dtype) if h0 is not None else None
    return ga.to(a.dtype), gs.to(a.dtype), gh0
