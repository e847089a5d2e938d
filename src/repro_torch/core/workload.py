"""Workload generators for the paper's scenarios (Sec I, III-D, XI).

The healthcare mix (Scenario 4 / XI): 1000 daily queries — 40%
high-sensitivity (local per HIPAA), 35% moderate (private edge tolerable),
25% low (public cloud acceptable). Query text is generated from templates so
MIST's regex + classifier actually fire on realistic content.
"""
from __future__ import annotations

import random

from repro_torch.core.tracegen import cyclic_text, sample_mixture_template
from repro_torch.core.waves import Request

_HIGH = [
    "Analyze treatment options for {age}-year-old diabetic patient {name} with elevated HbA1c",
    "Patient {name}, MRN: {mrn}, presents with hypertension; adjust lisinopril dosage",
    "Summarize lab results for patient {name}, SSN {ssn}, diagnosed with asthma",
    "Draft a referral for {name} (DOB: 1979-03-{dd}) regarding chemotherapy schedule",
    "Patient {name} reports depression symptoms; review sertraline treatment plan",
]
_MODERATE = [
    "Search medical literature for metaanalyses on statin efficacy",
    "Summarize our internal review of the oncology unit roadmap",
    "Draft meeting notes for the clinical ops team retro",
    "What does our team protocol say about triage escalation",
    "Compare insulin pump vendors for the procurement draft",
]
_LOW = [
    "What are common diabetes complications",
    "Explain how vaccines train the immune system",
    "General tips for improving sleep quality",
    "What is the recommended daily water intake",
    "How does blood pressure medication work in general",
]

_NAMES = ["John Doe", "Alice Johnson", "Maria Garcia", "Wei Chen", "Priya Patel"]


def _medical_fill(rng: random.Random) -> dict:
    """PHI-shaped template fills. Draw order (age, name, mrn, ssn x3, dd)
    is the historical ``str.format`` kwargs order — part of the seed
    contract shared with every committed benchmark artifact."""
    return dict(age=rng.randint(25, 80), name=rng.choice(_NAMES),
                mrn=rng.randint(10 ** 5, 10 ** 6),
                ssn=f"{rng.randint(100,999)}-{rng.randint(10,99)}-{rng.randint(1000,9999)}",
                dd=rng.randint(10, 28))


def healthcare_workload(n: int = 1000, seed: int = 0,
                        mix=(0.40, 0.35, 0.25)):
    """Returns list of (Request, true_tier) where true_tier is the paper's
    intended placement: 'high'|'moderate'|'low'.

    Built on ``tracegen.sample_mixture_template`` — the trace harness and
    the handcrafted benchmarks share one seeded corpus path, and the
    output is bit-identical to the pre-tracegen generator (parity-locked
    by tests/test_tracegen.py)."""
    rng = random.Random(seed)
    buckets = ((mix[0], _HIGH, "high", "primary"),
               (mix[1], _MODERATE, "moderate", "secondary"),
               (mix[2], _LOW, "low", "burstable"))
    out = []
    for _ in range(n):
        q, kind, prio = sample_mixture_template(rng, buckets, _medical_fill)
        out.append((Request(query=q, priority=prio, user=f"u{rng.randint(0,3)}"),
                    kind))
    return out


# ------------------------------------------------- seeded serving prompts
#
# The serving benchmark's A/B workloads and the privacy leakage
# benchmark's attack/bit-exactness workloads are built from the SAME
# generators below, so perf gates and attack gates can never silently
# diverge onto different request mixes.

SHARED_HEAD_TOKENS = 64          # shared head: 64 byte-tokens = 4 pages
LONG_PROMPT_CHARS = 75


def shared_head_prompts(n: int, head_tokens: int = SHARED_HEAD_TOKENS):
    """``n`` prompts sharing an identical ``head_tokens``-byte head
    followed by a distinct tail. Returns ``(head, prompts)``."""
    head = cyclic_text("the patient record header section ", head_tokens)
    return head, [head + f" case {i}" for i in range(n)]


def mixed_prefill_prompts(n_long: int = 3, n_short: int = 6,
                          long_chars: int = LONG_PROMPT_CHARS):
    """Head-of-line-blocking mix: a few long prompts ahead of many short
    ones. Returns ``(longs, shorts)``."""
    longs = [f"case history {i:02d} " + "y" * (long_chars - 16)
             for i in range(n_long)]
    shorts = [f"vitals {i}" for i in range(n_short)]
    return longs, shorts


def churn_prompts(n: int = 10):
    """Mixed-sensitivity prompts for the island-churn / migration runs.
    Returns ``[(prompt, sensitivity_override), ...]``."""
    return [(f"patient record number {i:02d} with several details",
             (0.9, 0.6, 0.2)[i % 3]) for i in range(n)]


def tiered_serving_prompts(n: int = 16, seed: int = 7):
    """Seeded healthcare prompts with a rotating trust-tier assignment
    (including untiered). Returns ``[(prompt, trust_tier), ...]`` — the
    fused-tick A/B and the constant-shape bit-exactness A/B both run
    exactly this workload."""
    wl = healthcare_workload(n, seed=seed)
    return [(req.query, (1, 2, 3, None)[i % 4])
            for i, (req, _kind) in enumerate(wl)]


_LEGAL = [
    "Find precedents for breach of fiduciary duty, case no: {x}",
    "Privileged and confidential: summarize deposition of {name}",
    "Retrieve similar contracts to the {org} asset purchase agreement",
]


def _legal_fill(rng: random.Random) -> dict:
    return dict(x=f"22-cv-{rng.randint(1000,9999)}", name=rng.choice(_NAMES),
                org=rng.choice(["Acme Corp", "Globex LLC", "Initech Inc"]))


def legal_workload(n: int = 200, seed: int = 0):
    """Scenario C: all case-law queries require the firm's vector index.
    Single-bucket fold onto the shared tracegen corpus path (parity-
    locked: no mixture draw, same per-request rng sequence)."""
    rng = random.Random(seed)
    buckets = ((1.0, _LEGAL, "high", "secondary"),)
    out = []
    for _ in range(n):
        q, kind, prio = sample_mixture_template(rng, buckets, _legal_fill)
        out.append((Request(query=q, dataset="caselaw-10tb",
                            priority=prio), kind))
    return out
