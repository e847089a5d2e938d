"""Token sampling: greedy.

Port of ``repro/serving/sampling.py`` for temperature 0. ``torch.argmax``
returns the FIRST maximal index, as ``jnp.argmax`` does, so greedy streams
can match the reference token for token. Stochastic sampling is not
ported yet: ``jax.random`` draws cannot be reproduced with a
``torch.Generator``, so it needs its own in-port parity tests.
"""
from __future__ import annotations

import torch


def sample(logits):
    """Greedy: logits (B, V) -> token ids (B,) int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
