"""Model assembly: a decoder of attention, Mamba-2 (SSM) and RG-LRU mixer
blocks, with a SwiGLU MLP after each mixer when ``d_ff`` is set.

Port of ``repro/models/model.py`` for patterns drawn from {``attn``,
``ssm``, ``rglru``} without MoE, a prefix-LM mask or a frontend, in every
mode the serving paths run: ``full`` (a whole prompt, with or without a
dense cache), ``chunk`` (paged prefill runs, attention only) and
``decode`` (against a dense cache or the paged pool). Each layer's mixer
is dispatched by its block type (``BLOCK_TABLE``/``BLOCK_APPLY``/
``BLOCK_CACHE``, as the reference). The
reference stores layers stacked along a leading dim and runs them with
``lax.scan``; the port keeps one parameter dict per layer
(``params["layers"][i]``) and runs them in a Python loop, in the same
depth order (head layers, then every pattern cycle, then tail layers —
``repro_torch.bridge`` maps the reference's layout onto this one).

Parameters are a nested dict of tensors (the reference's pytree, per
layer): ``embed`` (V, d), ``final_norm`` (d,), ``lm_head`` (d, V) unless
embeddings are tied, and per layer a ``mixer`` dict (attention, SSM or
RG-LRU) and, when ``d_ff`` is set, an ``mlp`` (SwiGLU) dict. Every
projection is a plain ``torch.matmul``; attention, the SSD chunk and the
RG-LRU recurrence go through ``repro_torch.kernels``. Attention layers
take ``cfg.attn_window`` as their local-attention window:
recurrentgemma-9b's are windowed.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, rglru, ssm
from repro_torch.models.layers import (PSpec, init_params, rms_norm,
                                       swiglu_apply, swiglu_table)


def effective_pattern(cfg):
    if cfg.use_mla:
        return ("mla",)
    return cfg.pattern


BLOCK_TABLE = {"attn": attention.attn_table, "ssm": ssm.ssm_table,
               "rglru": rglru.rglru_table}
BLOCK_APPLY = {"attn": attention.attn_apply, "ssm": ssm.ssm_apply,
               "rglru": rglru.rglru_apply}
BLOCK_CACHE = {"attn": attention.attn_cache_spec,
               "ssm": ssm.ssm_cache_spec,
               "rglru": rglru.rglru_cache_spec}

# what the port does not run yet, and the ROADMAP item that ports it
_NOT_PORTED = {"mla": "ROADMAP Queue 1, P12 (MLA)"}


def unported_reason(cfg):
    """None when the port runs ``cfg`` (a pattern drawn from {attn, ssm,
    rglru}, no MoE, no prefix-LM mask, no frontend), else what is missing
    and where ROADMAP queues it. A prefix-LM config is refused with or
    without its frontend: the reference attends its prefix both ways
    whatever the frontend, and the port's attention is causal."""
    for bt in effective_pattern(cfg):
        if bt not in BLOCK_TABLE:
            return (f"{bt!r} layers "
                    f"({_NOT_PORTED.get(bt, 'ROADMAP Queue 1, P12')})")
    if cfg.num_experts:
        return "MoE layers (ROADMAP Queue 1, P12 (MoE))"
    if cfg.prefix_lm:
        return ("the prefix-LM mask over the first "
                f"{cfg.num_prefix_tokens} tokens (ROADMAP Queue 1, P12 "
                "(prefix-LM))")
    if cfg.frontend is not None:
        return (f"the {cfg.frontend!r} frontend (ROADMAP Queue 1, P12 "
                f"(frontends))")
    return None


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


def _layer_table(cfg, block_type):
    t = {"mixer": BLOCK_TABLE[block_type](cfg)}
    if cfg.d_ff:
        t["mlp"] = {"ln": PSpec((cfg.d_model,), (None,), "zeros"),
                    **swiglu_table(cfg.d_model, cfg.d_ff)}
    return t


class Model:
    def __init__(self, cfg):
        why = unported_reason(cfg)
        if why is not None:
            raise NotImplementedError(
                f"{cfg.name}: the port does not run {why} yet; it runs "
                f"patterns of attn, ssm and rglru layers, got pattern "
                f"{effective_pattern(cfg)}")
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
        return _layer_table(self.cfg, self.block_types[idx])

    def cache_spec(self, batch, max_len):
        """Per layer, {name: shape} of the dense decode cache; attention
        layers hold ``min(cfg.attn_window, max_len)`` slots when
        windowed."""
        w = self.cfg.attn_window
        return [BLOCK_CACHE[bt](self.cfg, batch, max_len, w) if bt == "attn"
                else BLOCK_CACHE[bt](self.cfg, batch, max_len)
                for bt in self.block_types]

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, device=None):
        """A zeroed dense decode cache on ``device`` (None = the card): per
        layer an attention ``{"k", "v"}`` dict of (batch, W, Hkv, D)
        tensors (W = max_len, or the window's ring) or an SSM / RG-LRU
        ``{"conv", "h"}`` dict. ``h``, the recurrent state, is fp32 and
        every other leaf ``dtype``, as the reference. An fp8 ``dtype``
        (``float8_e4m3fn``, ``float8_e5m2``) adds fp32 ``k_scale``/
        ``v_scale`` leaves of ones (batch, W, Hkv) beside an attention
        layer's ``k``/``v``: K/V quantize on write with a
        per-token-per-head scale (``attention._fp8_quantize``). Zeros, not
        empty memory: a masked slot multiplies p = 0 by what it holds, and
        uninitialised memory may hold NaN bits."""
        dev = resolve_device(device)
        out = [{n: torch.zeros(sh, dtype=torch.float32 if n == "h"
                               else dtype, device=dev)
                for n, sh in layer.items()}
               for layer in self.cache_spec(batch, max_len)]
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
        ``device`` (None = the card) from one ``torch.Generator``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_params(self.param_table(), gen, dtype, dev)
        params["layers"] = [init_params(self.layer_table(i), gen, dtype, dev)
                            for i in range(self.cfg.num_layers)]
        return params

    # ------------------------------------------------------------ forward
    def _apply_layer(self, bt, p, x, positions, mode, cache, block_table,
                     dst_page):
        # only attention reads the window and the paged pool's block table
        # and targets
        kw = (dict(window=self.cfg.attn_window, block_table=block_table,
                   dst_page=dst_page) if bt == "attn" else {})
        x, cache = BLOCK_APPLY[bt](self.cfg, p["mixer"], x, positions,
                                   mode=mode, cache=cache, **kw)
        if "mlp" in p:
            x = x + swiglu_apply(p["mlp"], rms_norm(x, p["mlp"]["ln"]))
        return x, cache

    def forward(self, params, *, tokens, mode="full", cache=None, pos=None,
                block_table=None, dst_page=None):
        """Returns (logits, cache); ``cache`` is the list of per-layer
        cache dicts, updated in place, or None (the reference also returns
        an MoE aux loss, which the port's models do not have).

        mode='full': tokens (B, S) at positions 0..S-1; ``cache`` None or
        a dense cache from ``init_cache`` whose first S slots take the
        prompt's K/V (a windowed ring shorter than S takes the last
        tokens').
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
        emb = params["embed"]
        x = emb[tokens.long()]
        S = x.shape[1]
        if mode == "full":
            positions = torch.arange(S, dtype=torch.int32, device=x.device)
        elif mode == "chunk":
            starts = pos.reshape(-1).to(torch.int32)
            positions = starts[:, None] + torch.arange(
                S, dtype=torch.int32, device=x.device)[None]
        else:
            positions = pos
        for i, lp in enumerate(params["layers"]):
            c = cache[i] if cache is not None else None
            x, c = self._apply_layer(self.block_types[i], lp, x, positions,
                                     mode, c, block_table, dst_page)
            if cache is not None:
                cache[i] = c
        x = rms_norm(x, params["final_norm"])
        if cfg.tie_embeddings:
            logits = torch.matmul(x, emb.t())
        else:
            logits = torch.matmul(x, params["lm_head"])
        return logits, cache


def get_model(cfg) -> Model:
    return Model(cfg)
