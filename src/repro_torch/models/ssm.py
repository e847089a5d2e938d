"""Mamba-2 (SSD, state-space duality) block [arXiv:2405.21060].

Port of ``repro/models/ssm.py``. Chunked SSD: within a chunk the
sequence mixing is a masked quadratic form, which the hand-written kernel
``repro_torch.kernels.ssd.ssd_chunk`` (K5) computes for every (batch,
chunk, head) with the chunk's state summary; across chunks a small
recurrence over the per-chunk states runs here in PyTorch, as the
reference leaves it to XLA. Decode is the O(1) state update, in PyTorch
as in the reference.

The block's cache is ``{"conv", "h"}``: the last ``conv_width - 1``
PRE-conv features (B, W-1, inner + 2N) in the cache dtype (bf16 on the
serving paths) and the SSM state (B, H, P, N) in fp32. Caches are updated
IN PLACE (the reference returns new, donated arrays).

Tensor parallel over "model" (``sharding.LOCAL_RULES``): where the model
axis divides ``ssm_heads``, ``wz``, ``wx``, ``wdt``, ``conv_x`` and
``wo`` hold this rank's heads (``wo`` row-parallel, summed over "model"
after it); the rank reads its heads' part of the replicated ``dt_bias``,
``A_log`` and ``D``, and of ``gn``, whose gated norm over all of
``inner`` sums its squares over "model". ``wB``/``wC`` and their convs
are replicated. K5 runs on the local heads. The conv cache keeps the
rank's pre-conv channels (its ``inner`` slice, then B and C), where the
reference's axes replicate it: a deviation, which spares a gather of
the x features at every step (``conv_channels``). Where the rules split
``inner`` mid-head (a model axis that divides ``inner`` but not the
heads), the outputs of ``wz`` and ``wx`` and the ``conv_x`` weight are
gathered over "model" and the block runs whole on every rank, K5 at all
``ssm_heads``, as GSPMD reshards there; the conv cache then keeps every
channel, and ``wo``'s rows stay the rules' slice
(``layers.row_parallel``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.ssd import ssd_chunk
from repro_torch.models.layers import (PSpec, rms_norm, rms_norm_split,
                                       row_parallel)
from repro_torch.sharding import (column_in, gather_out, model_offset,
                                  model_ranks, row_out)


def causal_conv(x, w):
    """Depthwise causal conv: x (B, S, C), w (W, C).
    out[t] = sum_i w[i] * x[t - W + 1 + i], zeros before the sequence."""
    W = w.shape[0]
    S = x.shape[1]
    out = x * w[-1]
    for i in range(W - 1):
        shift = W - 1 - i
        out = out + F.pad(x, (0, 0, shift, 0))[:, :S] * w[i]
    return out


def ssm_table(cfg):
    d, inner, N = cfg.d_model, cfg.ssm_inner, cfg.ssm_state
    H, W = cfg.ssm_heads, cfg.conv_width
    return {
        "ln": PSpec((d,), (None,), "zeros"),
        "wz": PSpec((d, inner), (None, "ssm_heads")),
        "wx": PSpec((d, inner), (None, "ssm_heads")),
        "wB": PSpec((d, N), (None, None)),
        "wC": PSpec((d, N), (None, None)),
        "wdt": PSpec((d, H), (None, "ssm_heads")),
        "dt_bias": PSpec((H,), (None,), "dt_bias"),
        "A_log": PSpec((H,), (None,), "a_log"),
        "D": PSpec((H,), (None,), "ones"),
        "conv_x": PSpec((W, inner), (None, "ssm_heads"), scale=0.5),
        "conv_B": PSpec((W, N), (None, None), scale=0.5),
        "conv_C": PSpec((W, N), (None, None), scale=0.5),
        "gn": PSpec((inner,), (None,), "zeros"),
        "wo": PSpec((inner, d), ("ssm_heads", None)),
    }


def ssm_cache_spec(cfg, batch, max_len=None):
    """{name: (shape, logical axes)} of this block's decode cache (its
    size does not depend on ``max_len``)."""
    inner, N, W = cfg.ssm_inner, cfg.ssm_state, cfg.conv_width
    return {"conv": ((batch, W - 1, inner + 2 * N), ("batch", None, None)),
            "h": ((batch, cfg.ssm_heads, cfg.ssm_head_dim, N),
                  ("batch", "ssm_heads", None, None))}


def conv_channels(cfg) -> int:
    """The pre-conv channels this rank keeps in its conv cache: its
    ``inner`` slice where the model axis divides ``ssm_heads``, then B's
    and C's ``2N``."""
    n = model_ranks()
    inner = cfg.ssm_inner // n if cfg.ssm_heads % n == 0 else cfg.ssm_inner
    return inner + 2 * cfg.ssm_state


def _local(w, H, split):
    """This rank's ``H`` entries of a replicated per-head vector that
    split work reads."""
    return column_in(w).narrow(0, model_offset(H), H) if split else w


def ssd_chunked(x, dt, a, B_, C_, chunk):
    """SSD scan. x (B, S, H, P), dt (B, S, H) fp32 (post-softplus), a (H,)
    fp32 (negative), B_/C_ (B, S, N) fp32. Returns (y (B, S, H, P),
    h_final (B, H, P, N)), h_final being the inter-chunk recurrence's
    last carry.

    S pads to a multiple of Q = min(chunk, S) with dt = 0 steps (decay
    exp(0) = 1 and zero input: the state is unchanged, and their y rows
    are sliced off). K5 computes every chunk's pieces in one launch."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    S0 = S
    if S % Q:
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    Cc = C_.reshape(Bsz, nc, Q, N).float().contiguous()
    y_intra, state, decay, cum = ssd_chunk(
        x.reshape(Bsz, nc, Q, H, P).float().contiguous(),
        dt.reshape(Bsz, nc, Q, H).float().contiguous(),
        a.float().contiguous(),
        B_.reshape(Bsz, nc, Q, N).float().contiguous(), Cc)
    h_prev, h_final = ref.ssd_carry(state, decay)
    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc, h_prev,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)[:, :S0]
    return y, h_final


def ssm_apply(cfg, p, x, positions, *, mode, cache=None):
    """Mamba-2 block. mode 'full' (x (B, S, d); ``cache`` None or this
    layer's ``{"conv", "h"}``, which takes the prompt's conv tail and final
    state) or 'decode' (x (B, 1, d) against ``cache``). ``positions`` are
    not read: the state carries the position. Returns (x + out, cache)."""
    Bsz = x.shape[0]
    N, Pd, W = cfg.ssm_state, cfg.ssm_head_dim, cfg.conv_width
    H = p["wdt"].shape[1]                        # this rank's heads
    inner = H * Pd
    split = H != cfg.ssm_heads
    # inner split mid-head: its columns gathered, every head computed
    mid = p["wx"].shape[1] != inner
    tp = column_in if split else (lambda t: t)
    h = rms_norm(x, p["ln"])
    hs = tp(h)
    if mid:
        p = dict(p, conv_x=gather_out(p["conv_x"], -1))
        z = gather_out(torch.matmul(column_in(h), p["wz"]), -1)
        xs = gather_out(torch.matmul(column_in(h), p["wx"]), -1)
    else:
        z = torch.matmul(hs, p["wz"])
        xs = torch.matmul(hs, p["wx"])
    Bf = torch.matmul(h, p["wB"])
    Cf = torch.matmul(h, p["wC"])
    dt_raw = torch.matmul(hs, p["wdt"])
    feats = torch.cat([xs, Bf, Cf], dim=-1)      # pre-conv (B, S, inner+2N)
    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    a = -torch.exp(_local(p["A_log"], H, split).float())      # (H,)
    dt = F.softplus(dt_raw.float()
                    + _local(p["dt_bias"], H, split).float())
    D = _local(p["D"], H, split).float()

    if mode == "full":
        S = x.shape[1]
        conv = F.silu(causal_conv(feats, conv_w).float())
        xs_c, B_c, C_c = torch.split(conv, [inner, N, N], dim=-1)
        xh = xs_c.reshape(Bsz, S, H, Pd)
        y, h_fin = ssd_chunked(xh, dt, a, tp(B_c), tp(C_c), cfg.ssm_chunk)
        y = y + D[None, None, :, None] * xh
        if cache is not None:
            # the conv tail is the last W-1 PRE-conv features, zeros
            # before a prompt shorter than that
            tail = (feats[:, -(W - 1):] if S >= W - 1 else
                    F.pad(feats, (0, 0, W - 1 - S, 0)))
            cache["conv"].copy_(tail)
            cache["h"].copy_(h_fin)
    elif mode == "decode":                       # one token
        window = torch.cat([cache["conv"].to(feats.dtype), feats], dim=1)
        conv = torch.einsum("bwc,wc->bc", window, conv_w)[:, None, :]
        conv = F.silu(conv.float())
        xs_c, B_c, C_c = torch.split(conv, [inner, N, N], dim=-1)
        B_c, C_c = tp(B_c), tp(C_c)
        xh = xs_c.reshape(Bsz, 1, H, Pd)
        hprev = cache["h"].float()               # (B, H, P, N)
        dA = torch.exp(dt[:, 0, :] * a)          # (B, H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], B_c[:, 0],
                           xh[:, 0].float())
        h_new = dA[:, :, None, None] * hprev + upd
        y = torch.einsum("bn,bhpn->bhp", C_c[:, 0], h_new)[:, None]
        y = y + D[None, None, :, None] * xh
        cache["conv"].copy_(window[:, 1:])
        cache["h"].copy_(h_new)
    else:
        raise ValueError(f"ssm block: no mode {mode!r} (paged chunk runs "
                         f"are attention-only)")

    y = y.reshape(Bsz, -1, inner)
    gated = y * F.silu(z.float())
    if split:
        out = rms_norm_split(gated.to(x.dtype),
                             _local(p["gn"], inner, split), cfg.ssm_inner)
        out = row_out(torch.matmul(out, p["wo"]))
    else:
        out = row_parallel(rms_norm(gated.to(x.dtype), p["gn"]), p["wo"],
                           False)
    return x + out, cache
