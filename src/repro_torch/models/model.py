"""Model assembly: a decoder of attention, MLA, Mamba-2 (SSM) and RG-LRU
mixer blocks, each followed by a SwiGLU MLP (when ``d_ff`` is set) or a
Mixture-of-Experts block.

Port of ``repro/models/model.py`` in every mode the serving paths run:
``full`` (a whole prompt, with or without a dense cache), ``chunk``
(paged prefill runs, attention only) and ``decode`` (against a dense
cache or the paged pool). A prefix-LM config (paligemma-3b) masks its
prefix in ``full`` mode (``attention.py``); a frontend (paligemma's
vision, musicgen's audio) is, as in the reference, a stub whose
precomputed ``embeddings`` ``forward`` takes alone or before the tokens'
embeddings; the batchers serve by tokens. Each layer's mixer
is dispatched by its block type (``BLOCK_TABLE``/``BLOCK_APPLY``/
``BLOCK_CACHE``, as the reference); an MLA config (deepseek-v2-lite-16b)
runs ``mla`` layers. In an MoE config (deepseek, kimi-k2-1t-a32b) the
first ``first_dense_layers`` layers take the dense MLP and the rest the
``moe`` block, whose load-balance loss ``forward`` sums
(``return_aux``). The
reference stores layers stacked along a leading dim and runs them with
``lax.scan``; the port keeps one parameter dict per layer
(``params["layers"][i]``) and runs them in a Python loop, in the same
depth order (head layers, then every pattern cycle, then tail layers —
``repro_torch.bridge`` maps the reference's layout onto this one).

Parameters are a nested dict of tensors (the reference's pytree, per
layer): ``embed`` (V, d), ``final_norm`` (d,), ``lm_head`` (d, V) unless
embeddings are tied, and per layer a ``mixer`` dict (attention, MLA, SSM
or RG-LRU) and an ``mlp`` (SwiGLU) or ``moe`` dict. Every
projection is a plain ``torch.matmul``; attention, the SSD chunk and the
RG-LRU recurrence go through ``repro_torch.kernels``; MLA and MoE are
torch ops, as the reference's are XLA einsums. Attention layers
take ``cfg.attn_window`` as their local-attention window:
recurrentgemma-9b's are windowed.

``axes()``, ``abstract()``, ``cache_spec()`` and ``cache_axes()`` give
the logical sharding axes, meta-device stand-ins and cache layout in the
port's per-layer layout (the reference's per-layer entries, without its
stacked "layers" dim). Under a mesh (``sharding.axis_rules``) ``init``
keeps this rank's slice of every leaf as ``sharding.placed_axes`` places
it under ``sharding.LOCAL_RULES`` (the reference's rules: heads, kv
heads, ff, vocab, ssm_heads and lru over "model", an MoE block's experts
over "model"; with FSDP, ``apply_fsdp``'s dim of each large weight over
"pod" and "data" too), drawing every leaf whole as one process would,
and ``init_cache`` allocates this rank's slice of each cache leaf by
``cache_axes`` (its batch rows over the data axes; its kv heads, or a
sequence-sharded layer's slot range, over "model", the latter marked
``decode_sharded.SeqSplitCache``; a cache whose kv heads and slots the
model axis divides neither whole; Mamba-2's conv tail keeps the rank's
channels where it can, ``ssm.conv_channels``). ``forward`` then runs
on this rank's local tensors, tensor-parallel over "model" where GSPMD
partitions the reference: each block adds its collectives
(``sharding.column_in``, ``row_out``), the embedding is a masked lookup
of the rank's vocab rows summed over "model", the head is
column-parallel, and the logits are gathered over "model" unless the
caller takes the rank's vocab slice (``local_logits``: the train step's
cross-entropy). With FSDP a layer's split weights are gathered over the
data axes just before it runs (``sharding.fsdp_gather``, inside the
function ``remat`` recomputes, so a checkpointed group gathers them
again in the backward and keeps none), and the embedding and the head
before their use.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.models import attention, mla, rglru, ssm
from repro_torch.sharding import column_in, gather_out, model_offset, row_out
from repro_torch.models.decode_sharded import SeqSplitCache
from repro_torch.models.layers import (PSpec, abstract_params, init_params,
                                       param_axes, rms_norm, swiglu_apply,
                                       swiglu_table)
from repro_torch.models.moe import moe_apply, moe_table
from repro_torch.training.optim import at


def seq_split(layer_spec) -> bool:
    """Whether a layer's ``cache_spec`` entry splits its slots over
    "model" (a leaf's axes name "kv_seq")."""
    return any("kv_seq" in ax for _, ax in layer_spec.values())


def effective_pattern(cfg):
    if cfg.use_mla:
        return ("mla",)
    return cfg.pattern


BLOCK_TABLE = {"attn": attention.attn_table, "mla": mla.mla_table,
               "ssm": ssm.ssm_table, "rglru": rglru.rglru_table}
BLOCK_APPLY = {"attn": attention.attn_apply, "mla": mla.mla_apply,
               "ssm": ssm.ssm_apply, "rglru": rglru.rglru_apply}
BLOCK_CACHE = {"attn": attention.attn_cache_spec,
               "mla": mla.mla_cache_spec,
               "ssm": ssm.ssm_cache_spec,
               "rglru": rglru.rglru_cache_spec}


def resolve_device(device) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises: an
    entry point never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev


def _layer_block_type(cfg, idx):
    """The mixer of layer ``idx``: head layers take the base mixer, the
    rest cycle through the pattern (``repro/models/model.py:82-87``)."""
    pat = effective_pattern(cfg)
    n0 = cfg.first_dense_layers
    if idx < n0:
        return pat[0]
    return pat[(idx - n0) % len(pat)]


def _layer_uses_moe(cfg, idx):
    return cfg.num_experts > 0 and idx >= cfg.first_dense_layers


def _layer_table(cfg, block_type, use_moe):
    """Head layers (``first_dense_layers``) take the dense MLP, the rest
    the MoE block when the config has experts
    (``repro/models/model.py:72-91``)."""
    t = {"mixer": BLOCK_TABLE[block_type](cfg)}
    if use_moe:
        t["moe"] = moe_table(cfg)
    elif cfg.d_ff:
        t["mlp"] = {"ln": PSpec((cfg.d_model,), (None,), "zeros"),
                    **swiglu_table(cfg.d_model, cfg.d_ff)}
    return t


class Model:
    def __init__(self, cfg):
        self.cfg = cfg
        self.pattern = effective_pattern(cfg)
        self.block_types = [_layer_block_type(cfg, i)
                            for i in range(cfg.num_layers)]

    # ------------------------------------------------------------- tables
    def param_table(self):
        """Top-level table; layer ``i`` adds ``layer_table(i)``."""
        cfg = self.cfg
        t = {"embed": PSpec((cfg.vocab_size, cfg.d_model), ("vocab", None),
                            scale=0.02),
             "final_norm": PSpec((cfg.d_model,), (None,), "zeros")}
        if not cfg.tie_embeddings:
            t["lm_head"] = PSpec((cfg.d_model, cfg.vocab_size),
                                 (None, "vocab"))
        return t

    def layer_table(self, idx):
        return _layer_table(self.cfg, self.block_types[idx],
                            _layer_uses_moe(self.cfg, idx))

    def layer_spans(self):
        """[(lo, hi, grouped)]: the layers in depth order as the reference
        segments them (``repro/models/model.py:60-69``): each head layer
        alone, each repeating pattern group (``grouped``: the reference
        stacks these along a leading dim and scans them), each tail layer
        alone."""
        n0, L, P = self.cfg.first_dense_layers, self.cfg.num_layers, \
            len(self.pattern)
        n_groups = (L - n0) // P
        end = n0 + n_groups * P
        return ([(i, i + 1, False) for i in range(n0)]
                + [(lo, lo + P, True) for lo in range(n0, end, P)]
                + [(i, i + 1, False) for i in range(end, L)])

    def axes(self):
        """The logical axes of every parameter, in the params' layout."""
        out = param_axes(self.param_table())
        out["layers"] = [param_axes(self.layer_table(i))
                         for i in range(self.cfg.num_layers)]
        return out

    def abstract(self, dtype=torch.float32):
        """Meta tensors of every parameter's global shape: no storage."""
        out = abstract_params(self.param_table(), dtype)
        out["layers"] = [abstract_params(self.layer_table(i), dtype)
                         for i in range(self.cfg.num_layers)]
        return out

    def cache_spec(self, batch, max_len):
        """Per layer, {name: (global shape, logical axes)} of the dense
        decode cache; attention layers hold ``min(cfg.attn_window,
        max_len)`` slots when windowed. Mesh-aware, as the reference's:
        a layer whose kv heads the model axis does not divide (MLA: any
        model axis) shards its slots over it ("kv_seq", ``seq_split``)
        where the axis divides them, and otherwise keeps them whole."""
        w = self.cfg.attn_window
        return [BLOCK_CACHE[bt](self.cfg, batch, max_len, w) if bt == "attn"
                else BLOCK_CACHE[bt](self.cfg, batch, max_len)
                for bt in self.block_types]

    def cache_axes(self, batch, max_len):
        return [{n: sa[1] for n, sa in layer.items()}
                for layer in self.cache_spec(batch, max_len)]

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, device=None):
        """A zeroed dense decode cache on ``device`` (None = the card): per
        layer an attention ``{"k", "v"}`` dict of (batch, W, Hkv, D)
        tensors (W = max_len, or the window's ring), an MLA ``{"ckr"}``
        (batch, max_len, 1, kv_lora_rank + rope_head_dim) or an SSM /
        RG-LRU ``{"conv", "h"}`` dict. ``h``, the recurrent state, is
        fp32 and every other leaf ``dtype``, as the reference. An fp8
        ``dtype`` (``float8_e4m3fn``, ``float8_e5m2``) adds fp32
        ``k_scale``/``v_scale`` leaves of ones (batch, W, Hkv) beside an
        attention layer's ``k``/``v``: K/V quantize on write with a
        per-token-per-head scale (``attention._fp8_quantize``); an MLA
        ``ckr`` gets no scale and is a plain cast, as the reference's
        (scales sit only beside ``k``/``v``). Zeros, not
        empty memory: a masked slot multiplies p = 0 by what it holds, and
        uninitialised memory may hold NaN bits. Under a mesh, this rank's
        slice of each leaf (``cache_spec``'s axes under
        ``sharding.LOCAL_RULES``): its kv heads where the model axis
        divides them; else, for a seq-sharded layer, ``W / model`` of its
        W slots, in a ``decode_sharded.SeqSplitCache`` (the flag the
        layer's decode reads); else (the model axis divides neither the kv
        heads nor the slots) every slot and kv head, as the reference
        keeps such a cache whole; a Mamba-2 conv tail of the rank's
        channels where it can (``ssm.conv_channels``)."""
        dev = resolve_device(device)

        def shape(bt, name, sh, ax):
            loc = sharding.local_shape(sh, ax)
            if bt == "ssm" and name == "conv":
                loc = loc[:-1] + (ssm.conv_channels(self.cfg),)
            return loc

        out = [(SeqSplitCache if seq_split(layer) else dict)(
                   (n, torch.zeros(shape(bt, n, sh, ax),
                                   dtype=torch.float32 if n == "h" else dtype,
                                   device=dev))
                   for n, (sh, ax) in layer.items())
               for bt, layer in zip(self.block_types,
                                    self.cache_spec(batch, max_len))]
        if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            for layer in out:
                if "k" in layer:
                    for leaf in ("k", "v"):
                        layer[leaf + "_scale"] = torch.ones(
                            layer[leaf].shape[:-1], dtype=torch.float32,
                            device=dev)
        return out

    def init(self, seed=0, dtype=torch.float32, device=None):
        """Seeded random weights at the config's widths, drawn on
        ``device`` (None = the card) from one ``torch.Generator``. Under
        a mesh each leaf is drawn whole and this rank keeps its slice
        as ``sharding.placed_axes`` places it."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        placed = (sharding.placed_axes(self)
                  if sharding.current_mesh() is not None else None)

        def keep(axes):         # this rank's slice of each whole leaf
            if placed is None:
                return None
            return lambda path, w: sharding.local_slice(w, at(axes, path))
        params = init_params(self.param_table(), gen, dtype, dev,
                             keep(placed))
        params["layers"] = [init_params(
            self.layer_table(i), gen, dtype, dev,
            keep(placed and placed["layers"][i]))
            for i in range(self.cfg.num_layers)]
        return params

    # ------------------------------------------------------------ forward
    def _embed(self, emb, tokens):
        """The tokens' rows of the embedding table; with the vocabulary
        split over "model", a masked lookup of this rank's rows summed
        over "model" (each token's row lives on one rank)."""
        tok = tokens.long()
        V = emb.shape[0]
        if V == self.cfg.vocab_size:
            return emb[tok]
        ids = tok - model_offset(V)
        own = (ids >= 0) & (ids < V)
        x = emb[torch.clamp(ids, 0, V - 1)] * own[..., None].to(emb.dtype)
        return row_out(x)

    def _apply_layer(self, bt, p, x, positions, mode, cache, block_table,
                     dst_page):
        """One layer: the mixer, then the MoE block (its ``y`` added, its
        aux loss returned) or the dense MLP. Returns (x, cache, aux or
        None)."""
        # only attention reads the window and the paged pool's block table
        # and targets
        kw = (dict(window=self.cfg.attn_window, block_table=block_table,
                   dst_page=dst_page) if bt == "attn" else {})
        x, cache = BLOCK_APPLY[bt](self.cfg, p["mixer"], x, positions,
                                   mode=mode, cache=cache, **kw)
        aux = None
        if "moe" in p:
            y, aux = moe_apply(self.cfg, p["moe"], x)
            x = x + y
        elif "mlp" in p:
            x = x + swiglu_apply(p["mlp"], rms_norm(x, p["mlp"]["ln"]),
                                 ff=self.cfg.d_ff)
        return x, cache, aux

    def _run_layers(self, lo, hi, layers, x, positions, mode, cache,
                    block_table, dst_page):
        """Layers lo..hi-1 (``layers`` their params): (x, summed aux or
        None). With FSDP each layer's split weights are gathered here,
        just before it runs, and dropped after it."""
        aux_total = None
        placed = (sharding.placed_axes(self)["layers"]
                  if sharding.fsdp_on() else None)
        for i, lp in zip(range(lo, hi), layers):
            if placed is not None:
                lp = sharding.fsdp_gather(lp, placed[i])
            c = cache[i] if cache is not None else None
            x, c, aux = self._apply_layer(self.block_types[i], lp, x,
                                          positions, mode, c, block_table,
                                          dst_page)
            if cache is not None:
                cache[i] = c
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        return x, aux_total

    def forward(self, params, *, tokens=None, embeddings=None, mode="full",
                cache=None, pos=None, block_table=None, dst_page=None,
                return_aux=False, remat=False, triangular=True,
                local_logits=False):
        """Returns (logits, cache); ``cache`` is the list of per-layer
        cache dicts, updated in place, or None. With ``return_aux``,
        (logits, cache, aux): the fp32 sum of every MoE layer's
        load-balance loss (the reference's ``aux_total``; 0 without MoE
        layers).

        ``remat`` recomputes each repeating pattern group in the backward
        (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of
        its scanned group body), so a group's activations are not kept.
        ``triangular`` is the reference's switch between its attention
        paths; it changes nothing here: K4 skips the key tiles its mask
        hides at every length. Under a mesh that splits the vocabulary
        over "model", ``local_logits`` returns this rank's vocab slice of
        the logits (V / model entries from ``model_offset``) where the
        default gathers them whole.

        mode='full': tokens (B, S) and/or embeddings (B, P, d) — a
        frontend's precomputed embeddings, alone or placed before the
        tokens' embeddings, cast to the embedding table's dtype — at
        positions 0..S-1; ``cache`` None or a dense cache from
        ``init_cache`` whose first S slots take the prompt's K/V (a
        windowed ring shorter than S takes the last tokens').
        mode='decode': tokens (B, 1); ``pos`` a scalar or (B,)
        per-sequence absolute positions; ``cache`` a dense cache, or the
        pool's page dicts with block_table (B, N).
        mode='chunk': page-aligned prefill chunk runs — tokens
        (B, C*page_size) with one independent run per row, ``pos`` the (B,)
        absolute positions of each run's first token, ``block_table``
        (B, N) covering every page each row occupies through its run,
        ``dst_page`` (B, C) page ids the runs' K/V is scattered onto (the
        scratch page for prefix-shared chunks and padding)."""
        cfg = self.cfg
        placed = sharding.placed_axes(self) if sharding.fsdp_on() else None
        emb = params["embed"]
        if placed is not None:      # gathered once, for the head too
            emb = sharding.fsdp_gather(emb, placed["embed"])
        if embeddings is not None and tokens is not None:
            x = torch.cat([embeddings.to(emb.dtype), self._embed(emb, tokens)],
                          dim=1)
        elif embeddings is not None:
            x = embeddings.to(emb.dtype)
        else:
            x = self._embed(emb, tokens)
        S = x.shape[1]
        if mode == "full":
            positions = torch.arange(S, dtype=torch.int32, device=x.device)
        elif mode == "chunk":
            starts = pos.reshape(-1).to(torch.int32)
            positions = starts[:, None] + torch.arange(
                S, dtype=torch.int32, device=x.device)[None]
        else:
            positions = pos
        aux_total = None
        layers = params["layers"]
        for lo, hi, grouped in self.layer_spans():
            args = (lo, hi, layers[lo:hi], x, positions, mode, cache,
                    block_table, dst_page)
            if remat and grouped:
                x, aux = checkpoint(self._run_layers, *args,
                                    use_reentrant=False)
            else:
                x, aux = self._run_layers(*args)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        top = {k: params[k] for k in ("final_norm", "lm_head")
               if k in params}
        if placed is not None:
            top = sharding.fsdp_gather(top, {k: placed[k] for k in top})
        x = rms_norm(x, top["final_norm"])
        head = emb.t() if cfg.tie_embeddings else top["lm_head"]
        if head.shape[1] != cfg.vocab_size:      # column-parallel head
            logits = torch.matmul(column_in(x), head)
            if not local_logits:
                logits = gather_out(logits, -1)
        else:
            logits = torch.matmul(x, head)
        if not return_aux:
            return logits, cache
        if aux_total is None:
            aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, cache, aux_total


def get_model(cfg) -> Model:
    return Model(cfg)
