"""Serving driver: ``python -m repro_torch.launch.serve --requests 50``.

Port of ``repro/launch/serve.py``. Boots a three-tier island mesh
(personal laptop+phone, private edge, public cloud), serves a reduced
model on the laptop and home-nas SHORE islands, routes a healthcare
workload through WAVES and prints the per-island distribution, privacy
accounting and latency percentiles.

The default is the per-request loop (``InferenceEngine`` over
``LocalModelServer``s: full-prompt prefill into a dense cache, then
decode). ``--batched`` swaps it for the tick-based ``TickOrchestrator``:
the whole pending pool is routed per scheduling tick and SHORE work runs
through per-island continuous batchers (``--cache stacked|paged``,
``--prefill chunked|full``, ``--slots``).

``--arch`` picks the model (its ``.reduced()`` width); ``mamba2-370m``
and ``recurrentgemma-9b`` serve on both paths, through the stacked
batcher when ``--batched`` (``--cache auto`` resolves to it: an SSM or
RG-LRU config, or a windowed one, has no paged cache).
``--device`` picks where the models run: the card by default, ``cpu`` for
the plain versions of the kernels.

``--trace out.json`` (implies ``--batched``) attaches the operator-side
span tracer (``repro_torch.obs``) to the run and writes the request-span
journal as Chrome-trace/Perfetto JSON: islands as processes, decode
slots as tracks, migrations as flow arrows. Load it at ui.perfetto.dev
or chrome://tracing.

``--train-classifier`` first trains MIST's stage-2 classifier
(``core.mist_model``) on ``--device`` and hands it to MIST.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.islands import (IslandRegistry, cloud_island,
                                      edge_island, personal_island)
from repro_torch.core.lighthouse import Lighthouse
from repro_torch.core.mist import MIST
from repro_torch.core.tide import TIDE
from repro_torch.core.waves import WAVES, Policy
from repro_torch.core.workload import healthcare_workload
from repro_torch.serving.engine import InferenceEngine, LocalModelServer


def build_mesh(policy=None, buffer="moderate", classifier=None):
    reg = IslandRegistry()
    for isl in [
        personal_island("laptop", latency_ms=120, capacity_units=3.0,
                        models=("smoke",)),
        personal_island("phone", latency_ms=250, capacity_units=0.5),
        edge_island("home-nas", privacy=0.9, latency_ms=300,
                    capacity_units=2.0),
        edge_island("clinic-edge", privacy=0.8, latency_ms=450,
                    datasets=("medlit",), capacity_units=6.0),
        cloud_island("gpt4-api", privacy=0.4, cost=0.02, latency_ms=900),
        cloud_island("claude-api", privacy=0.5, cost=0.015, latency_ms=800),
    ]:
        reg.register(isl, reg.attestation_token(isl.island_id))
    mist = MIST(classifier=classifier)
    tide = TIDE(reg, buffer=buffer)
    lh = Lighthouse(reg)
    for i in reg.all():
        lh.heartbeat(i.island_id)
    waves = WAVES(mist, tide, lh, policy or Policy())
    return reg, waves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--buffer", default="moderate",
                    choices=("conservative", "moderate", "aggressive"))
    ap.add_argument("--mode", default="scalarized",
                    choices=("scalarized", "constraint"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the models and the router "
                         "(default: the card; 'cpu' runs the kernels' "
                         "plain versions)")
    ap.add_argument("--batched", action="store_true",
                    help="tick-based batched orchestrator instead of the "
                         "per-request loop")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous-batching decode slots per SHORE island "
                         "(--batched only)")
    ap.add_argument("--cache", default="auto",
                    choices=("auto", "stacked", "paged"),
                    help="KV-cache manager for --batched SHORE islands: "
                         "dense stacked slot rows or the trust-tiered "
                         "paged pool; auto = paged when the arch supports "
                         "it (--batched only)")
    ap.add_argument("--prefill", default="chunked",
                    choices=("chunked", "full"),
                    help="paged-pool prefill policy: prefix-aware chunked "
                         "admission or the monolithic full-prompt dispatch "
                         "(--batched only)")
    ap.add_argument("--train-classifier", action="store_true",
                    help="train the MIST stage-2 classifier first")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the request-span journal as Chrome-trace/"
                         "Perfetto JSON (implies --batched; operator-view "
                         "only)")
    args = ap.parse_args(argv)
    if args.trace and not args.batched:
        print("--trace implies --batched: enabling the tick orchestrator")
        args.batched = True

    clf = None
    if args.train_classifier:
        from repro_torch.core.mist_model import train_classifier
        clf = train_classifier(seed=args.seed, device=args.device)
        print(f"MIST stage-2 classifier trained "
              f"(train acc {clf.train_accuracy:.3f})")

    reg, waves = build_mesh(Policy(mode=args.mode), args.buffer, clf)
    cfg = get_config(args.arch).reduced()
    wl = healthcare_workload(args.requests, seed=args.seed)
    tracer = None
    if args.batched:
        from repro_torch.serving.batcher import make_batcher
        from repro_torch.serving.engine import TickOrchestrator
        if args.trace:
            from repro_torch.obs import Tracer
            tracer = Tracer()
        batchers = {iid: make_batcher(cfg, cache=args.cache,
                                      num_slots=args.slots,
                                      prefill=args.prefill,
                                      max_len=128, seed=args.seed,
                                      device=args.device)
                    for iid in ("laptop", "home-nas")}
        eng = TickOrchestrator(waves, reg, batchers, seed=args.seed,
                               tracer=tracer, device=args.device)
    else:
        servers = {iid: LocalModelServer(cfg, max_len=128, seed=args.seed,
                                         device=args.device)
                   for iid in ("laptop", "home-nas")}
        eng = InferenceEngine(waves, reg, servers, seed=args.seed)
    for req, kind in wl:
        eng.submit(req, max_new_tokens=args.max_new_tokens)
    if args.batched:
        eng.run_until_done()
    print(json.dumps(eng.stats(), indent=1))
    if tracer is not None:
        from repro_torch.obs import write_chrome_trace
        n = write_chrome_trace(tracer, args.trace)
        print(f"wrote {n} trace events to {args.trace} "
              f"(load at ui.perfetto.dev)")
    return eng


if __name__ == "__main__":
    main()
