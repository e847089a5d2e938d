"""Access-pattern privacy: adversary harness + per-signal leakage scoring.

Port of ``repro/privacy/__init__.py``. ``adversary`` drives the port's
serving stack with an attacker tenant interleaved against victims and
scores each observable channel's attack accuracy; ``leakage`` (a verbatim
copy of the reference's) turns those accuracies into normalized
per-signal risk scores and an aggregate LPS-style figure.
"""
from repro_torch.privacy.adversary import (AttackResult, AttackStack,
                                           Mitigations, run_attack_suite)
from repro_torch.privacy.leakage import (CHANNEL_WEIGHTS, advantage,
                                         leakage_report)

__all__ = ["AttackResult", "AttackStack", "Mitigations",
           "run_attack_suite", "CHANNEL_WEIGHTS", "advantage",
           "leakage_report"]
