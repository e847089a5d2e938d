"""Synthetic LM data pipeline: deterministic, shardable, dependency-free.

Generates zipf-distributed token streams with injected local structure
(bigram templates) so models actually have something to learn in the
end-to-end training driver; also packs real text via the byte tokenizer.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer


class SyntheticLM:
    """Infinite batch iterator of (tokens, labels) with zipf marginals and
    deterministic per-step seeds (restart-safe: seek(step))."""

    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0,
                 alpha: float = 1.1, frontend: str | None = None,
                 d_model: int = 0, num_prefix: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.frontend = frontend
        self.d_model = d_model
        self.num_prefix = num_prefix
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** -alpha
        self._p = p / p.sum()
        self.step = 0

    def seek(self, step: int):
        self.step = step

    def _tokens(self, rng, b, s):
        t = rng.choice(self.vocab, size=(b, s), p=self._p)
        # inject learnable bigram structure: token v is often followed by
        # (v*7+1) % vocab
        follow = (t[:, :-1] * 7 + 1) % self.vocab
        mask = rng.random((b, s - 1)) < 0.5
        t[:, 1:] = np.where(mask, follow, t[:, 1:])
        return t.astype(np.int32)

    def next_batch(self):
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        out = {}
        if self.frontend == "audio":
            out["embeddings"] = rng.standard_normal(
                (self.batch, self.seq, self.d_model), np.float32)
            out["labels"] = self._tokens(rng, self.batch, self.seq)
        elif self.frontend == "vision":
            out["embeddings"] = rng.standard_normal(
                (self.batch, self.num_prefix, self.d_model), np.float32)
            toks = self._tokens(rng, self.batch, self.seq - self.num_prefix)
            out["tokens"] = toks
            out["labels"] = toks
        else:
            toks = self._tokens(rng, self.batch, self.seq)
            out["tokens"] = toks
            out["labels"] = toks
        return out

    def __iter__(self):
        while True:
            yield self.next_batch()


def pack_texts(texts, vocab_size: int, seq: int):
    """Pack real texts to fixed-length (tokens, labels) arrays."""
    tok = ByteTokenizer(vocab_size)
    rows = []
    for t in texts:
        ids = tok.encode(t)[:seq]
        ids = ids + [0] * (seq - len(ids))
        rows.append(ids)
    arr = np.asarray(rows, np.int32)
    return {"tokens": arr, "labels": arr}
