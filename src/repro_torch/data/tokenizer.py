"""Byte-level tokenizer (offline, dependency-free).

Maps UTF-8 bytes to ids (+specials), folding into the model vocab when the
vocab is smaller than 256+specials (smoke models). Good enough for driving
real text through real models in examples/tests without external files.
"""
from __future__ import annotations

PAD, BOS, EOS = 0, 1, 2
N_SPECIAL = 3


class ByteTokenizer:
    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str, bos: bool = True):
        ids = [N_SPECIAL + b for b in text.encode("utf-8")]
        if self.vocab_size < 256 + N_SPECIAL:
            ids = [N_SPECIAL + (i - N_SPECIAL) % (self.vocab_size - N_SPECIAL)
                   for i in ids]
        return ([BOS] if bos else []) + ids

    def decode(self, ids) -> str:
        bs = bytes(max(0, i - N_SPECIAL) % 256 for i in ids
                   if i >= N_SPECIAL)
        return bs.decode("utf-8", errors="replace")
