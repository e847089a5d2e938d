"""Per-signal leakage scoring (LPS decomposition spirit).

Each observable channel gets a normalized risk score derived from the
adversary's attack accuracy on that channel:

    advantage = max(0, (accuracy - chance) / (1 - chance))

so 0.0 means the channel taught the adversary nothing beyond guessing
and 1.0 means perfect reconstruction. The aggregate LPS is the
weight-normalized sum over channels present in a run — comparable
across runs that exercise different attack subsets.
"""
from __future__ import annotations

# Relative weight of each channel in the aggregate score. Share-hit
# counters rank highest (they directly encode cross-tenant content
# overlap); routing and work-clock deltas reveal coarser facts.
CHANNEL_WEIGHTS = {
    "hit_rate": 0.30,
    "peak_pages": 0.20,
    "dispatch_shape": 0.15,
    "backlog": 0.15,
    "scheduling": 0.15,
    "work_clock": 0.10,
    "routing": 0.10,
}


def advantage(accuracy: float, chance: float) -> float:
    """Normalized advantage over random guessing, clamped at 0."""
    return max(0.0, (accuracy - chance) / max(1.0 - chance, 1e-9))


def leakage_report(results: dict) -> dict:
    """Score a ``run_attack_suite`` result dict.

    Returns ``{"per_signal": [...], "lps": float}`` where each
    per-signal entry carries the raw accuracy, chance rate, normalized
    advantage and its weighted risk contribution.
    """
    per_signal = []
    wsum = 0.0
    acc = 0.0
    for name in sorted(results):
        r = results[name]
        adv = advantage(r.accuracy, r.chance)
        w = CHANNEL_WEIGHTS.get(r.signal, 0.1)
        per_signal.append({
            "attack": r.name,
            "signal": r.signal,
            "n_classes": r.n_classes,
            "chance": r.chance,
            "accuracy": r.accuracy,
            "n_test": r.n_test,
            "advantage": adv,
            "risk": w * adv,
        })
        wsum += w
        acc += w * adv
    return {"per_signal": per_signal,
            "lps": acc / wsum if wsum else 0.0}
