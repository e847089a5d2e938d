"""Seeded trace generation for the million-user load harness.

Every benchmark gate before this module drove 9-16 handcrafted requests;
the ROADMAP's north star is heavy traffic from millions of users. This
module closes the gap with a *fully deterministic* trace generator: one
``random.Random(seed)`` instance, consumed in a documented order, with
arrivals placed on virtual scheduler ticks — never wall time — so the
same ``TraceSpec`` always yields a bit-identical request stream that CI
can gate by exit code (the repo's noisy-wallclock rule).

What a trace exhibits, per IslandRun's request-level heterogeneity
argument (Sec Design) and the edge-orchestration survey in PAPERS.md:

* **Poisson-mixture arrivals** in virtual ticks: a base rate modulated
  by a diurnal sinusoid (virtual "days") and periodic burst windows.
* **Heavy-tailed lengths**: bounded-Pareto prompt and output token
  counts (byte tokenizer: chars == tokens).
* **Zipfian prefix reuse**: a corpus of shared heads sampled with
  Zipf(s) popularity, so the paged pool's prefix sharing and chunked
  prefill's chunk skipping actually matter at scale.
* **Mixed everything else**: SLO classes (``SLOClass`` targets +
  per-class ``deadline_ms``), tenants, trust tiers and priorities drawn
  from configurable mixtures.

The sampling primitives (``sample_mixture_template``, ``cyclic_text``,
``mixture_index``, ...) are shared with ``core.workload`` — the
handcrafted benchmark corpora are thin wrappers over the same seeded
path, parity-locked by tests so artifacts never silently diverge.

THE RNG CALL ORDER IS PART OF THE SEED CONTRACT. Per request:
class -> tenant -> tier -> prompt length -> output length -> reuse
coin -> (head index if reused). Changing the order, or the number of
draws, changes every committed artifact downstream.
"""
from __future__ import annotations

import math
import random
from bisect import bisect_left
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

from repro_torch.core.waves import Request
from repro_torch.serving.degrade import SLOClass

__all__ = [
    "ArrivalSpec", "LengthSpec", "PrefixSpec", "TraceSpec", "TraceRequest",
    "SLOClass", "default_slo_classes", "generate_trace", "trace_summary",
    "stream_trace", "head_corpus", "mixture_index", "bounded_pareto_int",
    "poisson", "cyclic_text", "sample_mixture_template", "ZipfSampler",
    "SENSITIVITY_FOR_TIER",
]

# Trust tier -> MIST sensitivity override carried by generated requests.
# Values sit in the middle of each ``trust_tier_for_sensitivity`` band so
# the KV pool tags pages with exactly the requested tier without running
# the (host-side, per-prompt) MIST analyzer inside the 10k+ hot loop.
SENSITIVITY_FOR_TIER = {1: 0.9, 2: 0.6, 3: 0.2, None: None}


# --------------------------------------------------------- rng primitives

def mixture_index(rng: random.Random, weights) -> int:
    """Draw an index from a discrete mixture with one uniform draw.
    Weights are normalized; the last bucket absorbs float round-off."""
    u = rng.random()
    total = float(sum(weights)) or 1.0
    acc = 0.0
    for i, w in enumerate(weights):
        acc += w / total
        if u < acc:
            return i
    return len(weights) - 1


def bounded_pareto_int(rng: random.Random, alpha: float, lo: int,
                       hi: int) -> int:
    """Heavy-tailed integer in ``[lo, hi]``: a Pareto(alpha) tail hanging
    off ``lo``, truncated at ``hi``. One uniform draw."""
    u = 1.0 - rng.random()                       # in (0, 1], avoids div-0
    return min(hi, max(lo, int(lo / u ** (1.0 / alpha))))


def poisson(rng: random.Random, lam: float) -> int:
    """Poisson draw via Knuth's product method, chunked so large rates
    never underflow ``exp(-lam)`` (sum of independent Poissons is
    Poisson). Deterministic given the rng state."""
    if lam <= 0.0:
        return 0
    k = 0
    while lam > 30.0:                            # exp(-30) ~ 9e-14: safe
        k += _poisson_knuth(rng, 30.0)
        lam -= 30.0
    return k + _poisson_knuth(rng, lam)


def _poisson_knuth(rng: random.Random, lam: float) -> int:
    limit = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1


def cyclic_text(phrase: str, n_chars: int) -> str:
    """First ``n_chars`` characters of ``phrase`` repeated — the byte
    tokenizer makes chars tokens, so this pads prompts to an exact token
    length with plausible text."""
    return "".join(phrase[i % len(phrase)] for i in range(n_chars))


def sample_mixture_template(rng: random.Random, buckets,
                            fill: Callable[[random.Random], dict]):
    """Shared corpus primitive: pick a weighted bucket, pick a template
    within it, format with ``fill(rng)``.

    ``buckets`` is ``((weight, templates, tag, priority), ...)``; returns
    ``(text, tag, priority)``. Consumes rng draws in the exact order the
    legacy workload generators did (mixture uniform — skipped entirely
    for a single bucket — then template choice, then every fill draw;
    fills run even when a template uses no placeholders, mirroring
    ``str.format`` kwargs evaluation), so callers passing the historical
    weights reproduce the historical corpora bit-identically.
    """
    chosen = buckets[-1]
    if len(buckets) > 1:
        u = rng.random()
        acc = 0.0
        for b in buckets:
            acc += b[0]
            if u < acc:
                chosen = b
                break
    _w, templates, tag, priority = chosen
    t = rng.choice(templates)
    return t.format(**fill(rng)), tag, priority


class ZipfSampler:
    """Zipf(s) over ``n`` ranks with a precomputed CDF: rank 0 is the
    most popular. One uniform draw per sample."""

    def __init__(self, n: int, s: float):
        if n < 1:
            raise ValueError("ZipfSampler needs n >= 1")
        weights = [1.0 / (i + 1) ** s for i in range(n)]
        total = sum(weights)
        cdf, acc = [], 0.0
        for w in weights:
            acc += w / total
            cdf.append(acc)
        cdf[-1] = 1.0
        self.cdf = cdf

    def sample(self, rng: random.Random) -> int:
        return bisect_left(self.cdf, rng.random())


# ----------------------------------------------------------------- specs

@dataclass(frozen=True)
class ArrivalSpec:
    """Arrival process in virtual ticks: Poisson with rate
    ``base_rate * diurnal(t) * burst(t)``."""

    base_rate: float = 5.0            # mean arrivals per tick
    diurnal_period: int = 400         # ticks per virtual day (0 disables)
    diurnal_amplitude: float = 0.5    # rate swing, fraction of base
    burst_every: int = 160            # burst window period (0 disables)
    burst_length: int = 10            # ticks per burst window
    burst_multiplier: float = 3.0     # rate multiplier inside a burst

    def rate_at(self, t: int) -> float:
        rate = self.base_rate
        if self.diurnal_period > 0:
            rate *= 1.0 + self.diurnal_amplitude * math.sin(
                2.0 * math.pi * t / self.diurnal_period)
        if self.burst_every > 0 and (t % self.burst_every) < self.burst_length:
            rate *= self.burst_multiplier
        return max(rate, 0.0)


@dataclass(frozen=True)
class LengthSpec:
    """Bounded-Pareto token lengths (byte tokenizer: chars == tokens)."""

    prompt_min: int = 12
    prompt_max: int = 88
    prompt_alpha: float = 1.1
    output_min: int = 2
    output_max: int = 12
    output_alpha: float = 1.4


@dataclass(frozen=True)
class PrefixSpec:
    """Zipfian shared-head reuse over a fixed corpus."""

    corpus_size: int = 24             # distinct shared heads
    head_tokens: int = 32             # tokens per head (2 pages of 16)
    zipf_s: float = 1.1               # popularity skew
    reuse_p: float = 0.6              # P(request reuses a shared head)


def default_slo_classes():
    """The standard three-class ladder: ``((SLOClass, weight), ...)``.

    Targets are island-local work-clock units (the same clock batcher
    ``request_log`` TTFT is stamped in); ``deadline_ms`` converts 1:1 to
    mesh work units via ``SLO_WORK_PER_MS``. ``batch`` has no targets and
    no deadline — it is the sheddable, preemptible background class.
    """
    return (
        (SLOClass("interactive", deadline_ms=6000.0, ttft_work_target=256.0,
                  tpot_work_target=64.0, priority="primary"), 0.30),
        (SLOClass("standard", deadline_ms=9000.0, ttft_work_target=768.0,
                  tpot_work_target=128.0, priority="secondary"), 0.45),
        (SLOClass("batch", priority="burstable"), 0.25),
    )


@dataclass(frozen=True)
class TraceSpec:
    """Everything that determines a trace. Same spec => same trace."""

    n_requests: int = 10_000
    seed: int = 0
    arrivals: ArrivalSpec = field(default_factory=ArrivalSpec)
    lengths: LengthSpec = field(default_factory=LengthSpec)
    prefix: PrefixSpec = field(default_factory=PrefixSpec)
    classes: tuple = field(default_factory=default_slo_classes)
    tenants: tuple = (("t0", 1.0), ("t1", 1.0), ("t2", 1.0), ("t3", 1.0))
    tiers: tuple = ((1, 0.40), (2, 0.35), (3, 0.25))

    def slo_classes(self) -> dict:
        """Class-name -> SLOClass table, ready for the orchestrator."""
        return {c.name: c for c, _w in self.classes}

    def scaled(self, n_requests: int) -> "TraceSpec":
        """Same statistical shape, different request count."""
        return replace(self, n_requests=n_requests)


@dataclass(frozen=True)
class TraceRequest:
    """One trace entry, fully materialized and immutable."""

    idx: int
    arrival_tick: int
    prompt: str
    max_new_tokens: int
    slo_class: str
    priority: str
    tenant: str
    trust_tier: Optional[int]
    prefix_id: int = -1               # shared-head rank, -1 = private

    def to_request(self) -> Request:
        return Request(query=self.prompt, priority=self.priority,
                       user=self.tenant, slo_class=self.slo_class,
                       sensitivity_override=SENSITIVITY_FOR_TIER.get(
                           self.trust_tier))


# ------------------------------------------------------------ generation

def head_corpus(prefix: PrefixSpec) -> list:
    """The shared-head corpus for a spec: rank-ordered, deterministic."""
    return [cyclic_text(f"shared corpus head {h:03d} common preamble ",
                        prefix.head_tokens)
            for h in range(prefix.corpus_size)]


def generate_trace(spec: TraceSpec) -> list:
    """Materialize the full trace: a list of ``TraceRequest`` sorted by
    (non-decreasing) ``arrival_tick``. Pure function of ``spec``."""
    rng = random.Random(spec.seed)
    heads = head_corpus(spec.prefix)
    zipf = ZipfSampler(spec.prefix.corpus_size, spec.prefix.zipf_s)
    class_list = [c for c, _w in spec.classes]
    class_weights = [w for _c, w in spec.classes]
    tenant_names = [t for t, _w in spec.tenants]
    tenant_weights = [w for _t, w in spec.tenants]
    tier_values = [t for t, _w in spec.tiers]
    tier_weights = [w for _t, w in spec.tiers]
    L = spec.lengths

    out: list[TraceRequest] = []
    t = 0
    while len(out) < spec.n_requests:
        n_arr = poisson(rng, spec.arrivals.rate_at(t))
        for _ in range(min(n_arr, spec.n_requests - len(out))):
            idx = len(out)
            cls = class_list[mixture_index(rng, class_weights)]
            tenant = tenant_names[mixture_index(rng, tenant_weights)]
            tier = tier_values[mixture_index(rng, tier_weights)]
            plen = bounded_pareto_int(rng, L.prompt_alpha, L.prompt_min,
                                      L.prompt_max)
            olen = bounded_pareto_int(rng, L.output_alpha, L.output_min,
                                      L.output_max)
            reuse = rng.random() < spec.prefix.reuse_p
            if reuse:
                hid = zipf.sample(rng)
                plen = max(plen, spec.prefix.head_tokens + 8)
                tail = f" q{idx} {tenant} "
                body = heads[hid] + tail
            else:
                hid = -1
                body = f"q{idx:05d} {tenant} request body "
            if len(body) < plen:
                body += cyclic_text("follow-up detail segment ",
                                    plen - len(body))
            out.append(TraceRequest(
                idx=idx, arrival_tick=t, prompt=body,
                max_new_tokens=olen, slo_class=cls.name, priority=cls.priority,
                tenant=tenant, trust_tier=tier, prefix_id=hid))
        t += 1
    return out


def trace_summary(trace) -> dict:
    """Deterministic shape statistics for tests and benchmark artifacts."""
    n = len(trace)

    def counts(key):
        return _counts(trace, key)

    reused = sum(1 for r in trace if r.prefix_id >= 0)
    return {
        "n": n,
        "span_ticks": (trace[-1].arrival_tick - trace[0].arrival_tick + 1
                       if trace else 0),
        "class_mix": counts(lambda r: r.slo_class),
        "tenant_mix": counts(lambda r: r.tenant),
        "tier_mix": counts(lambda r: r.trust_tier),
        "reuse_rate": reused / n if n else 0.0,
        "head_counts": _counts([r for r in trace if r.prefix_id >= 0],
                               lambda r: r.prefix_id),
        "mean_prompt_tokens": (sum(len(r.prompt) for r in trace) / n
                               if n else 0.0),
        "mean_output_tokens": (sum(r.max_new_tokens for r in trace) / n
                               if n else 0.0),
    }


def _counts(items, key) -> dict:
    out: dict = {}
    for it in items:
        k = key(it)
        out[k] = out.get(k, 0) + 1
    return out


# ------------------------------------------------------------- streaming

def stream_trace(orch, trace, max_ticks: int = 200_000,
                 on_tick: Optional[Callable] = None) -> list:
    """Stream a trace through an orchestrator in virtual time: each
    iteration submits every request whose ``arrival_tick`` has come due,
    then runs one ``orch.tick()``; continues until every request has
    resolved. Returns rids aligned with ``trace`` order. Duck-typed
    (``submit`` / ``tick`` / ``busy``), so tests can drive fakes."""
    rids = []
    i, ticks = 0, 0
    while i < len(trace) or orch.busy():
        while i < len(trace) and trace[i].arrival_tick <= ticks:
            tr = trace[i]
            rids.append(orch.submit(tr.to_request(),
                                    max_new_tokens=tr.max_new_tokens))
            i += 1
        orch.tick()
        if on_tick is not None:
            on_tick(orch)
        ticks += 1
        if ticks >= max_ticks:
            raise RuntimeError(
                f"trace did not drain in {max_ticks} ticks "
                f"({len(trace) - i} unsubmitted)")
    return rids
