"""Model assembly for attention-only decoders (attention + SwiGLU).

Port of ``repro/models/model.py`` for attention-only patterns, in every
mode the serving paths run: ``full`` (a whole prompt, with or without a
dense cache), ``chunk`` (paged prefill runs) and ``decode`` (against a
dense cache or the paged pool). The reference stores layers stacked
along a leading dim and runs them with ``lax.scan``; the port keeps one parameter dict per layer
(``params["layers"][i]``) and runs them in a Python loop, in the same
depth order (head layers, then every pattern cycle, then tail layers —
``repro_torch.bridge`` maps the reference's layout onto this one).

Parameters are a nested dict of tensors (the reference's pytree, per
layer): ``embed`` (V, d), ``final_norm`` (d,), ``lm_head`` (d, V) unless
embeddings are tied, and per layer ``mixer`` (attention) and ``mlp``
(SwiGLU) dicts. Every projection is a plain ``torch.matmul``; attention
goes through ``repro_torch.kernels``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention
from repro_torch.models.layers import (PSpec, init_params, rms_norm,
                                       swiglu_apply, swiglu_table)


def effective_pattern(cfg):
    if cfg.use_mla:
        return ("mla",)
    return cfg.pattern


def attention_only(cfg) -> bool:
    """The configs this port runs: every layer attention + dense MLP."""
    return (set(effective_pattern(cfg)) == {"attn"} and not cfg.num_experts
            and cfg.frontend is None)


def resolve_device(device) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises: an
    entry point never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev


def _layer_table(cfg):
    t = {"mixer": attention.attn_table(cfg)}
    if cfg.d_ff:
        t["mlp"] = {"ln": PSpec((cfg.d_model,), (None,), "zeros"),
                    **swiglu_table(cfg.d_model, cfg.d_ff)}
    return t


class Model:
    def __init__(self, cfg):
        if not attention_only(cfg):
            raise NotImplementedError(
                f"{cfg.name}: the port runs attention-only decoders so far, "
                f"got pattern {effective_pattern(cfg)}"
                f"{' with MoE' if cfg.num_experts else ''}")
        self.cfg = cfg
        self.pattern = effective_pattern(cfg)

    # ------------------------------------------------------------- tables
    def param_table(self):
        """Top-level table; every layer adds ``layer_table()``."""
        cfg = self.cfg
        t = {"embed": PSpec((cfg.vocab_size, cfg.d_model), ("vocab", None),
                            scale=0.02),
             "final_norm": PSpec((cfg.d_model,), (None,), "zeros")}
        if not cfg.tie_embeddings:
            t["lm_head"] = PSpec((cfg.d_model, cfg.vocab_size),
                                 (None, "vocab"))
        return t

    def layer_table(self):
        return _layer_table(self.cfg)

    def cache_spec(self, batch, max_len):
        """Per layer, {name: shape} of the dense decode cache."""
        return [attention.attn_cache_spec(self.cfg, batch, max_len)
                for _ in range(self.cfg.num_layers)]

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, device=None):
        """A zeroed dense decode cache on ``device`` (None = the card): one
        ``{"k", "v"}`` dict of (batch, max_len, Hkv, D) tensors per layer.
        Zeros, not empty memory: a masked slot multiplies p = 0 by what it
        holds, and uninitialised memory may hold NaN bits."""
        dev = resolve_device(device)
        return [{n: torch.zeros(sh, dtype=dtype, device=dev)
                 for n, sh in layer.items()}
                for layer in self.cache_spec(batch, max_len)]

    def init(self, seed=0, dtype=torch.float32, device=None):
        """Seeded random weights at the config's widths, drawn on
        ``device`` (None = the card) from one ``torch.Generator``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_params(self.param_table(), gen, dtype, dev)
        params["layers"] = [init_params(self.layer_table(), gen, dtype, dev)
                            for _ in range(self.cfg.num_layers)]
        return params

    # ------------------------------------------------------------ forward
    def _apply_layer(self, p, x, positions, mode, cache, block_table,
                     dst_page):
        x, cache = attention.attn_apply(
            self.cfg, p["mixer"], x, positions, mode=mode, cache=cache,
            block_table=block_table, dst_page=dst_page)
        if "mlp" in p:
            x = x + swiglu_apply(p["mlp"], rms_norm(x, p["mlp"]["ln"]))
        return x, cache

    def forward(self, params, *, tokens, mode="full", cache=None, pos=None,
                block_table=None, dst_page=None):
        """Returns (logits, cache); ``cache`` is the list of per-layer
        cache dicts, updated in place, or None (the reference also returns
        an MoE aux loss, which attention-only models do not have).

        mode='full': tokens (B, S) at positions 0..S-1; ``cache`` None or
        a dense cache from ``init_cache`` whose first S slots take the
        prompt's K/V.
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
            x, c = self._apply_layer(lp, x, positions, mode, c, block_table,
                                     dst_page)
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
