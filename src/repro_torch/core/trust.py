"""Trust composition (paper Sec VII-C and Eq. (2)).

The paper is internally inconsistent: Sec VII-C composes trust with ``min``
("conservative composition") while Eq. (2) in Sec VIII-E uses a product.
Both are implemented; ``min`` is the default because the surrounding text
argues for the conservative reading ("an island cannot claim high trust
without meeting all criteria" — which both satisfy, but the worked examples
match min).
"""
from __future__ import annotations

# Sec VII-C reference values
BASE_TRUST = {"local": 1.0, "private_edge": 0.8, "public_cloud": 0.5}
CERT_TRUST = {"iso27001": 1.0, "soc2": 0.9, "self": 0.7}
JURISDICTION_TRUST = {"same_country": 1.0, "eu_gdpr": 0.9, "foreign": 0.6}


def compose_trust(base: float, cert: float, jurisdiction: float,
                  mode: str = "min") -> float:
    for v in (base, cert, jurisdiction):
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"trust component out of range: {v}")
    if mode == "min":
        return min(base, cert, jurisdiction)
    if mode == "product":
        return base * cert * jurisdiction
    raise ValueError(f"unknown trust mode {mode!r}")
