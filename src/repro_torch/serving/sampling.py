"""Token sampling: greedy / temperature / top-k / top-p.

Port of ``repro/serving/sampling.py``. The filters are the reference's:

* the logits are divided by ``max(temperature, 1e-6)``;
* top-k keeps every logit ``>=`` the k-th largest (ties at the k-th all
  survive);
* top-p sorts the logits in descending order, takes the softmax and its
  cumulative sum, and masks every logit below the one at
  ``min(sum(csum < top_p), V - 1)`` (``top_p = 1.0`` keeps everything);
* ``temperature <= 0`` is greedy: ``torch.argmax`` returns the FIRST
  maximal index, as ``jnp.argmax`` does, so greedy streams can match the
  reference token for token.

The draw is the Gumbel-max of the filtered logits (categorical sampling,
as ``jax.random.categorical`` does it), with uniforms from a
COUNTER-BASED integer hash of ``(stream seed, draw index, vocab index)``
rather than a ``torch.Generator``: the CPU and CUDA generators give
different streams, while the hash gives the same uniforms on the card and
on the CPU, and a row's noise depends only on its own key, never on its
row in the batch. A key is ``(stream seed, draws so far)``; a batcher sets
it at admission and advances the draw index by one per draw, so a frozen
request's ticket carries its place in its stream. The hash runs in int64
torch ops that cannot overflow: 32-bit mixing with every product split
into 16-bit halves and masked to 32 bits; a uniform takes the top 24 bits.

``jax.random`` streams cannot be reproduced (ROADMAP R2): stochastic
parity with the reference is statistical, and only the filters are
checked exactly.
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
# murmur3's 32-bit finalizer constants, and the golden-ratio increment that
# separates the three words of a counter
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) without an
    intermediate above 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def stream_key(seed: int, n: int) -> tuple:
    """The sampling key of the ``n``-th admission of a batcher built with
    ``seed``: ``(stream seed, 0)``, a stream seed the same 32-bit mixing
    derives from both numbers, at its first draw."""
    h = _fmix32(torch.tensor((seed ^ _GOLDEN) & _MASK32, dtype=torch.int64))
    return (int(_fmix32(h ^ ((n + _GOLDEN) & _MASK32)).item()), 0)


def counter_bits(seeds, draws, vocab: int):
    """(B, V) int64 hash values in [0, 2**32) of ``(seeds[b], draws[b],
    v)``; ``seeds``/``draws`` are (B,) int64 tensors on the logits'
    device."""
    v = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    h = _fmix32((seeds & _MASK32) ^ _GOLDEN)
    h = _fmix32(h ^ ((draws + _GOLDEN) & _MASK32))
    return _fmix32(h[:, None] ^ ((v[None, :] * _GOLDEN) & _MASK32))


def gumbel_noise(seeds, draws, vocab: int):
    """(B, V) float32 Gumbel(0, 1) noise from the counter hash: the top 24
    bits give a uniform in (0, 1) (exact in float64 on both devices)."""
    u = ((counter_bits(seeds, draws, vocab) >> 8).to(torch.float64)
         + 0.5) / float(1 << 24)
    return (-torch.log(-torch.log(u))).to(torch.float32)


def filter_logits(logits, temperature: float, top_k: int = 0,
                  top_p: float = 1.0):
    """The reference's temperature, top-k and top-p filters: (B, V)
    logits -> float32 (B, V) with every filtered entry at -inf."""
    V = logits.shape[-1]
    lg = logits.to(torch.float32) / max(float(temperature), 1e-6)
    if top_k:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -torch.inf), lg)
    sorted_l = torch.sort(lg, dim=-1, descending=True).values
    csum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
    cutoff_idx = torch.clamp((csum < top_p).sum(-1, keepdim=True),
                             max=V - 1)
    cutoff = torch.gather(sorted_l, -1, cutoff_idx)
    return torch.where(lg < cutoff, torch.full_like(lg, -torch.inf), lg)


def _keys_tensor(key, rows: int, device):
    k = torch.as_tensor(key, dtype=torch.int64).reshape(-1, 2)
    if k.shape[0] == 1 and rows != 1:
        k = k.expand(rows, 2)
    if k.shape[0] != rows:
        raise ValueError(f"{k.shape[0]} sample keys for {rows} rows")
    return k.to(device)


def sample(logits, key=None, temperature: float = 0.0, top_k: int = 0,
           top_p: float = 1.0):
    """logits (B, V) -> token ids (B,) int32. ``temperature <= 0`` is
    greedy and needs no key; otherwise ``key`` is one ``(seed, draw)``
    pair for every row, or a (B, 2) int64 table of them (a list of pairs
    or a tensor): the Gumbel-max of the filtered logits."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    keys = _keys_tensor(key, logits.shape[0], logits.device)
    return perturbed_scores(logits, keys, temperature, top_k,
                            top_p).argmax(-1).to(torch.int32)


def perturbed_scores(logits, keys, temperature: float, top_k: int = 0,
                     top_p: float = 1.0):
    """The scores whose argmax ``sample`` takes at ``temperature > 0``:
    the filtered logits plus the counter Gumbel noise of each row's key
    ((B, 2) int64 on the logits' device)."""
    lg = filter_logits(logits, temperature, top_k, top_p)
    return lg + gumbel_noise(keys[:, 0], keys[:, 1], lg.shape[-1])
