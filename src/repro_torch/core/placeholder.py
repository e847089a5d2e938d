"""Reversible typed placeholders (paper Sec VII-B, Def. 4).

Entities become coarse typed placeholders ([PERSON_3], [LOCATION_B], ...)
with a bidirectional per-session mapping phi: Placeholder <-> PII, so a
cloud response mentioning "[PERSON_3]" is de-anonymized before the user sees
it. Identifiers are randomized per session (Attack-3 mitigation: mapping
changes across sessions, so cross-user frequency analysis of placeholder
ids carries no signal).
"""
from __future__ import annotations

import random
import re
import string
from dataclasses import dataclass, field

# coarse-grained types only (paper: PERSON not PATIENT/DOCTOR)
TYPES = ("PERSON", "LOCATION", "ID", "MEDICAL_CONDITION",
         "TEMPORAL_REFERENCE", "ORG", "FINANCIAL", "CONTACT")

_PH_RE = re.compile(r"\[(" + "|".join(TYPES) + r")_([A-Z0-9]+)\]")


class PlaceholderStore:
    """Bidirectional mapping phi for one conversation session."""

    def __init__(self, seed: int | None = None):
        self._rng = random.Random(seed)
        self.fwd: dict[str, str] = {}   # entity text -> placeholder
        self.rev: dict[str, str] = {}   # placeholder -> entity text
        self._salt = "".join(self._rng.choices(string.ascii_uppercase, k=2))
        self._counters: dict[str, int] = {}

    def placeholder_for(self, entity: str, etype: str) -> str:
        if etype not in TYPES:
            raise ValueError(f"unknown entity type {etype}")
        key = entity.strip()
        if key in self.fwd:
            return self.fwd[key]
        n = self._counters.get(etype, self._rng.randint(1, 9))
        self._counters[etype] = n + 1
        ph = f"[{etype}_{self._salt}{n}]"
        self.fwd[key] = ph
        self.rev[ph] = key
        return ph

    def apply(self, text: str, entities) -> str:
        """entities: iterable of (entity_text, type); longest-first so
        overlapping spans resolve deterministically."""
        for ent, etype in sorted(entities, key=lambda e: -len(e[0])):
            if not ent.strip():
                continue
            ph = self.placeholder_for(ent, etype)
            text = text.replace(ent, ph)
        return text

    def restore(self, text: str) -> str:
        """Backward pass: placeholders -> original entities."""
        def sub(m):
            return self.rev.get(m.group(0), m.group(0))
        return _PH_RE.sub(sub, text)

    def contains_pii(self, text: str) -> bool:
        return any(ent in text for ent in self.fwd)

    def __len__(self):
        return len(self.fwd)
