"""Access-pattern adversary harness (the attack side of the privacy gate).

Port of ``repro/privacy/adversary.py``: the reference's harness, line for
line, pointed at the port's serving stack (``device`` places every batcher
it builds; None = the card, as at every entry point).

A co-tenant ("the adversary") runs its OWN legitimate requests through the
real serving stack — the same ``TickOrchestrator``, batchers and KV pools
production uses — interleaved against victim tenants, and tries to
reconstruct cross-request facts from signals it can legitimately observe:

* mesh pool telemetry (``Lighthouse.pool_telemetry`` /
  ``mesh_prefill_backlog``) — today exposed raw, per island, to any
  caller;
* per-tick dispatch geometry (``PagedContinuousBatcher.dispatch_shapes``
  — a stand-in for the launch timing/power side channel a co-resident
  tenant gets for free);
* its own requests' completion timing (TTFT in orchestrator ticks).

Each attack is a standard membership/attribute-inference game: fixed
candidate classes, a calibration phase (the adversary observes each class
once), then balanced test trials classified with a nearest-mean rule.
Everything is deterministic — greedy decoding, seeded workloads,
value-keyed telemetry noise — so accuracies are exact and CI can gate
"mitigations on => accuracy <= chance + slack" AND the positive control
"mitigations off => the leak is demonstrated" without flakes.

Threat model (see the reference's docs/architecture.md): the gated
adversary is a LOW-trust tenant (tier 3 cloud) attacking HIGH-sensitivity
victims (tier 1 personal). Same-tier co-tenants intentionally share prefix state,
so their mutual observability is by design, not a leak.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.islands import IslandRegistry, personal_island
from repro_torch.core.lighthouse import Lighthouse, TelemetryPolicy
from repro_torch.core.mist import MIST
from repro_torch.core.tide import TIDE
from repro_torch.core.waves import WAVES, Policy, Request
from repro_torch.core.workload import shared_head_prompts
from repro_torch.serving.batcher import make_batcher
from repro_torch.serving.engine import (TickOrchestrator,
                                       build_island_batchers)

ATTACKER_TIER = 3        # cloud-tier co-tenant (sensitivity < 0.5)
ATTACKER_SENS = 0.2
VICTIM_SENS = 0.9        # -> trust tier 1 (personal)


@dataclass(frozen=True)
class Mitigations:
    """Which hardening layers are active for a harness run."""
    tier_scoped_telemetry: bool = False   # lighthouse scoped view
    noised_telemetry: bool = False        # quantize + value-keyed noise
    constant_shape: bool = False          # fixed-geometry dispatch
    tier_quotas: bool = False             # per-tier scheduling quotas

    @classmethod
    def off(cls) -> "Mitigations":
        return cls()

    @classmethod
    def on(cls) -> "Mitigations":
        return cls(tier_scoped_telemetry=True, noised_telemetry=True,
                   constant_shape=True, tier_quotas=True)


@dataclass(frozen=True)
class AttackResult:
    name: str
    signal: str           # which observable channel the attack reads
    n_classes: int
    chance: float
    accuracy: float
    n_test: int


@dataclass
class TrialObs:
    """One trial's observation stream: telemetry before submission, the
    per-orchestrator-tick views while the trial drains, and the tick
    count until the adversary's own probe completed (0 = no probe)."""
    base: dict
    ticks: list
    probe_done_ticks: int


# ------------------------------------------------------------ the stack

class AttackStack:
    """A real serving mesh (registry + WAVES + TickOrchestrator + paged
    island batchers) plus the adversary's observation taps, configured
    for one mitigation setting."""

    def __init__(self, cfg, params, mitigations: Mitigations,
                 islands=(("local", None),), max_len=160,
                 prefill_token_budget=None, seed=0, tracer=None,
                 device=None):
        self.mitigations = mitigations
        reg = IslandRegistry()
        for n, (iid, model) in enumerate(islands):
            isl = personal_island(iid, latency_ms=100.0 + 10.0 * n,
                                  capacity_units=2.0,
                                  models=(model,) if model else ())
            reg.register(isl, reg.attestation_token(iid))
        self.island_ids = sorted(iid for iid, _m in islands)
        mist, tide = MIST(), TIDE(reg)
        self.lh = Lighthouse(reg, telemetry_policy=TelemetryPolicy(
            tier_scoped=mitigations.tier_scoped_telemetry,
            noise=mitigations.noised_telemetry, seed=seed))
        for i in reg.all():
            self.lh.heartbeat(i.island_id)
        waves = WAVES(mist, tide, self.lh, Policy())
        bats = build_island_batchers(
            cfg, reg, cache="paged", params=params, max_len=max_len,
            slots_per_capacity_unit=2.0, seed=seed,
            prefill_token_budget=prefill_token_budget,
            constant_shape=mitigations.constant_shape, device=device)
        self.batchers = bats
        # operator-side span tracer; the adversary NEVER reads it (its
        # taps stay `observe()`/`max_dispatch_shape`), so the leakage
        # benchmark can gate "attack accuracies identical traced vs not"
        self.orch = TickOrchestrator(waves, reg, bats,
                                     decode_ticks_per_tick=1,
                                     tracer=tracer, device=device)
        self._trial = 0

    # ----------------------------------------------------- observation
    def observe(self) -> dict:
        """What the adversary reads between its own ticks. Mitigated
        stacks expose only the tier-scoped lighthouse view; the
        unmitigated baseline reads the raw per-island telemetry exactly
        as any caller can today."""
        if self.mitigations.tier_scoped_telemetry:
            view = self.lh.pool_telemetry(viewer_tier=ATTACKER_TIER)
            return {"share_hits": view.get("share_hits", 0),
                    "pages": view.get("pages_in_use", 0),
                    "backlog": self.lh.mesh_prefill_backlog(
                        viewer_tier=ATTACKER_TIER),
                    "work": 0,          # never published across the tier
                    "per_island_pages": {}}     # boundary; no islands
        raw = self.lh.pool_telemetry()
        return {"share_hits": sum(int(s.get("share_hits", 0))
                                  for s in raw.values()),
                "pages": sum(int(s.get("in_use", 0))
                             for s in raw.values()),
                "backlog": self.lh.mesh_prefill_backlog(),
                "work": sum(int(s.get("work_clock", 0))
                            for s in raw.values()),
                "per_island_pages": {iid: int(s.get("in_use", 0))
                                     for iid, s in raw.items()}}

    def max_dispatch_shape(self):
        """Peak dispatch geometry across the stack's islands — the
        launch-shape channel (prefill rows/pages/width, decode width)."""
        pre = [(0, 0, 0)]
        dec = [(0, 0)]
        for b in self.batchers.values():
            for s in getattr(b, "dispatch_shapes", ()):
                if s[0] == "prefill":
                    pre.append(s[1:])
                else:
                    dec.append(s[1:])
        return (max(p[0] for p in pre), max(p[1] for p in pre),
                max(p[2] for p in pre), max(d[1] for d in dec))

    # ----------------------------------------------------------- trials
    def run_trial(self, victims, probe=True, probe_model=None,
                  max_ticks=400) -> TrialObs:
        """One attack trial: submit the victim requests, interleave the
        adversary's own probe, then tick the orchestrator to completion,
        observing telemetry after every tick."""
        base = self.observe()
        for k, v in enumerate(victims):
            self.orch.submit(
                Request(query=v["prompt"], priority="primary",
                        user=f"victim-{self._trial}-{k}",
                        sensitivity_override=v.get("sensitivity",
                                                   VICTIM_SENS),
                        model=v.get("model")),
                max_new_tokens=v.get("max_new", 4))
        probe_rid = None
        if probe:
            probe_rid = self.orch.submit(
                Request(query=f"adv probe {self._trial:03d}",
                        priority="primary",
                        user=f"adversary-{self._trial}",
                        sensitivity_override=ATTACKER_SENS,
                        model=probe_model),
                max_new_tokens=3)
        t0 = self.orch.tick_stats["ticks"]
        ticks = []
        probe_done = 0
        n = 0
        while self.orch.busy() and n < max_ticks:
            self.orch.tick()
            n += 1
            ticks.append(self.observe())
            if probe_rid is not None and not probe_done \
                    and probe_rid in self.orch.results:
                probe_done = self.orch.tick_stats["ticks"] - t0
        self._trial += 1
        return TrialObs(base=base, ticks=ticks,
                        probe_done_ticks=probe_done)


# ------------------------------------------------- classification protocol

def _dist(a, b) -> float:
    return sum((float(x) - float(y)) ** 2 for x, y in zip(a, b))


def _nearest(means: dict, v) -> int:
    """Nearest calibration mean; exact ties resolve to the LOWEST class,
    so information-free (constant) features score exactly chance on a
    balanced test set."""
    best, bd = None, None
    for c in sorted(means):
        d = _dist(means[c], v)
        if bd is None or d < bd - 1e-12:
            best, bd = c, d
    return best


def _mean(feats):
    return tuple(sum(f[i] for f in feats) / len(feats)
                 for i in range(len(feats[0])))


def run_protocol(n_classes, trial_fn, extractors, cal_per_class=1,
                 test_per_class=2) -> dict:
    """Calibrate-then-classify over SHARED trials: ``trial_fn(c)`` runs
    one trial of class ``c`` and returns an observation; each extractor
    maps an observation to its feature vector and is scored independently
    (several attacks can read different signals from the same trials).
    Test labels are interleaved/balanced, so chance is exactly
    1/n_classes. Returns {extractor_name: (accuracy, n_test)}."""
    cal = {c: [trial_fn(c) for _ in range(cal_per_class)]
           for c in range(n_classes)}
    labels = [c for _ in range(test_per_class) for c in range(n_classes)]
    tests = [(c, trial_fn(c)) for c in labels]
    out = {}
    for name, ex in extractors.items():
        means = {c: _mean([ex(o) for o in obs]) for c, obs in cal.items()}
        hits = sum(1 for c, o in tests if _nearest(means, ex(o)) == c)
        out[name] = (hits / len(tests), len(tests))
    return out


def _max_delta(obs: TrialObs, key: str) -> int:
    if not obs.ticks:
        return 0
    return max(t[key] for t in obs.ticks) - obs.base[key]


# ------------------------------------------------------------ the attacks

def _victim_prompt(trial: int, chars: int) -> str:
    """A victim prompt of exactly ``chars`` characters (``chars + 1``
    byte-tokens with BOS), unique per trial so no accidental cross-trial
    prefix sharing muddies the game."""
    return (f"v{trial:03d} " + "x" * chars)[:chars]


def run_attack_suite(cfg, params, mitigations: Mitigations,
                     include=None, cal_per_class=1,
                     test_per_class=2, tracer=None, device=None) -> dict:
    """Run every attack (or the ``include`` subset) against a stack built
    with ``mitigations``; returns {attack_name: AttackResult}.

    ``tracer`` attaches an operator-side span tracer to every stack the
    suite builds (the tracing-enabled leakage leg): it must change NO
    accuracy, since the journal never feeds the adversary's features.
    ``device`` places every batcher (None = the card)."""
    results: dict[str, AttackResult] = {}

    def sel(name):
        return include is None or name in include

    def record(name, signal, n_classes, acc, n_test):
        results[name] = AttackResult(
            name=name, signal=signal, n_classes=n_classes,
            chance=1.0 / n_classes, accuracy=acc, n_test=n_test)

    # ---- 1. prefix membership (hit_rate): does victim B share victim
    # A's 64-token prompt head? The adversary watches the mesh share-hit
    # counter move while both drain.
    if sel("prefix_membership"):
        stack = AttackStack(cfg, params, mitigations, tracer=tracer,
                            device=device)
        head, _prompts = shared_head_prompts(1)
        writer = head + " alpha"
        member = head + " beta"
        outsider = ("unrelated billing question about quarterly invoice "
                    "totals and the payment schedule")[:len(member)]

        def trial(bit):
            return stack.run_trial(
                [{"prompt": writer},
                 {"prompt": member if bit else outsider}])

        acc = run_protocol(
            2, trial, {"f": lambda o: (_max_delta(o, "share_hits"),)},
            cal_per_class, test_per_class)["f"]
        record("prefix_membership", "hit_rate", 2, *acc)

    # ---- 2+3. victim prompt-length bucket via pool occupancy
    # (peak_pages) and via work-clock/timing deltas (work_clock), read
    # from the SAME trials. The prefill budget covers victim + probe in
    # one tick, so the probe's own latency is scheduling-invariant and
    # the only timing signal is the published work counter.
    if sel("victim_length_pages") or sel("victim_length_work"):
        stack = AttackStack(cfg, params, mitigations,
                            prefill_token_budget=256, tracer=tracer,
                            device=device)
        chars = (15, 31, 63, 127)        # 1 / 2 / 4 / 8 KV pages

        def trial(c):
            return stack.run_trial(
                [{"prompt": _victim_prompt(stack._trial, chars[c])}])

        accs = run_protocol(
            4, trial,
            {"pages": lambda o: (_max_delta(o, "pages"),),
             "work": lambda o: (
                 (o.ticks[-1]["work"] - o.base["work"]) if o.ticks else 0,
                 o.probe_done_ticks)},
            cal_per_class, test_per_class)
        if sel("victim_length_pages"):
            record("victim_length_pages", "peak_pages", 4,
                   *accs["pages"])
        if sel("victim_length_work"):
            record("victim_length_work", "work_clock", 4, *accs["work"])

    # ---- 4. victim prompt-length bucket via prefill backlog: a small
    # per-tick budget leaves length-proportional backlog visible for
    # several ticks. No probe — the channel is pure telemetry.
    if sel("victim_length_backlog"):
        stack = AttackStack(cfg, params, mitigations,
                            prefill_token_budget=32, tracer=tracer,
                            device=device)
        chars = (31, 63, 95, 127)        # 32 / 64 / 96 / 128 tokens

        def trial(c):
            return stack.run_trial(
                [{"prompt": _victim_prompt(stack._trial, chars[c])}],
                probe=False)

        acc = run_protocol(
            4, trial, {"f": lambda o: (_max_delta(o, "backlog"),)},
            cal_per_class, test_per_class)["f"]
        record("victim_length_backlog", "backlog", 4, *acc)

    # ---- 5. dispatch-shape channel: which length bucket did the victim
    # fall in, read from launch geometry alone (fresh island per trial =
    # the cold-start worst case, before bucket ratcheting blurs shapes).
    if sel("dispatch_shape"):
        shape_classes = (15, 127)

        def trial(c):
            b = make_batcher(
                cfg, cache="paged", num_slots=4, max_len=160,
                params=params, prefill_token_budget=32,
                constant_shape=mitigations.constant_shape, device=device)
            if tracer is not None:
                b.attach_tracer(tracer, island="shape-island")
            b.submit(_victim_prompt(trial.n, shape_classes[c]),
                     max_new_tokens=4, trust_tier=1)
            b.submit(f"adv probe {trial.n:03d}", max_new_tokens=3,
                     trust_tier=ATTACKER_TIER)
            trial.n += 1
            b.run_until_done()
            pre = [(0, 0, 0)] + [s[1:] for s in b.dispatch_shapes
                                 if s[0] == "prefill"]
            dec = [(0, 0)] + [s[1:] for s in b.dispatch_shapes
                              if s[0] == "decode"]
            return (max(p[0] for p in pre), max(p[1] for p in pre),
                    max(p[2] for p in pre), max(d[1] for d in dec))
        trial.n = 0

        acc = run_protocol(2, trial, {"f": lambda o: o},
                           cal_per_class, test_per_class)["f"]
        record("dispatch_shape", "dispatch_shape", 2, *acc)

    # ---- 6. routing inference: which island served the victim (model
    # pinning makes placement the secret bit), read from per-island page
    # telemetry. The adversary's probe pins itself to island A so its own
    # load never confounds the signal.
    if sel("island_routing"):
        stack = AttackStack(cfg, params, mitigations,
                            islands=(("island-a", "model-a"),
                                     ("island-b", "model-b")),
                            tracer=tracer, device=device)

        def trial(bit):
            return stack.run_trial(
                [{"prompt": _victim_prompt(stack._trial, 63),
                  "model": "model-b" if bit else "model-a"}],
                probe_model="model-a")

        def per_island(o):
            return tuple(
                max((t["per_island_pages"].get(iid, 0) for t in o.ticks),
                    default=0)
                - o.base["per_island_pages"].get(iid, 0)
                for iid in stack.island_ids)

        acc = run_protocol(2, trial, {"f": per_island},
                           cal_per_class, test_per_class)["f"]
        record("island_routing", "routing", 2, *acc)

    # ---- 7. scheduling interference: how much co-tenant work shares the
    # batcher, read from the adversary's OWN probe timing alone (TTFT +
    # completion tick). With a shared rotating-RR prefill budget and
    # first-come slot allocation, heavy tier-1 traffic delays the tier-3
    # probe; per-tier quotas reserve the probe's slots and sub-budget, so
    # its schedule is invariant to the victims' load (the PR-7 residual).
    if sel("scheduling_interference"):
        sched_classes = ((1, 15), (3, 119))   # (n victims, prompt chars)

        def trial(c):
            b = make_batcher(
                cfg, cache="paged", num_slots=6, max_len=160,
                params=params, prefill_token_budget=32,
                constant_shape=mitigations.constant_shape,
                tier_quotas={1: 3, ATTACKER_TIER: 3}
                if mitigations.tier_quotas else None, device=device)
            if tracer is not None:
                b.attach_tracer(tracer, island="sched-island")
            n_vic, chars = sched_classes[c]
            for k in range(n_vic):
                b.submit(_victim_prompt(trial.n * 8 + k, chars),
                         max_new_tokens=4, trust_tier=1)
            probe = b.submit(f"adv probe {trial.n:03d}",
                             max_new_tokens=3, trust_tier=ATTACKER_TIER)
            trial.n += 1
            b.run_until_done()
            rec = b.request_log[probe]
            return (rec.get("ttft_ticks", 0), rec.get("done_tick", 0))
        trial.n = 0

        acc = run_protocol(2, trial, {"f": lambda o: o},
                           cal_per_class, test_per_class)["f"]
        record("scheduling_interference", "scheduling", 2, *acc)

    return results
