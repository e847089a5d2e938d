"""Fused route+serve: WAVES routing INSIDE the decode step, on the
multi-pod mesh, with the cost of moving a request's context across pods.

Port of ``repro/launch/routed_serve.py``. The paper's island
abstraction maps onto pods: each pod is an island group, and WAVES
assigns requests to pods. The routed step runs the capacity-aware tick
router (``core.routing.route_batch_tick``) over every request, then
permutes the requests to their pod's batch rows before the decode step,
and the logits back after it. Moving only the TOKENS is cheap; moving
the KV CACHE too (``migrate_cache``: a conversation following its user
to another island) moves the whole context.

The batch permutation is the one new mechanism on a mesh. Each rank
holds its rows of the batch (split over "pod" and "data"), and a
permutation chosen on the device can send any row anywhere, so
``permute_rows`` gathers the global tensor on every rank
(``sharding.gather_global``: an all-reduce of a zero-filled global buffer
per batch axis of more than one rank) and each rank keeps its rows of
the permuted one. Its sizes depend only on the shapes, so the dry-run
counts it on meta tensors. It moves more bytes than the rotation of
``local x (n - 1)`` that XLA lowers the reference's permutation to:
``main`` records both, each under its own name.

``build`` lowers the routed step as the dry-run lowers a step
(``launch/dryrun.py``: rank 0's local meta tensors under the 2 x 16 x 16
production mesh on a fake process group, counted); ``run`` serves real
tensors (a prefill, then routed decode steps) on the card, the CPU or a
small (pod, data, model) mesh of ranks. Run
``python -m repro_torch.launch.routed_serve [--arch qwen3-4b]``: it
writes ``build/routed_serve_<arch>_<shape>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path

import torch

from repro_torch import sharding
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.core import routing
from repro_torch.core.islands import (IslandRegistry, cloud_island,
                                      edge_island, personal_island)
from repro_torch.core.tide import TIDE
from repro_torch.launch.dryrun import (count_step, local_params, ring_bytes,
                                       window_config)
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models.model import get_model
from repro_torch.models.steps import make_prefill_step, make_serve_step

RESULTS = Path(__file__).resolve().parents[3] / "build"
# (w_cost, w_latency, w_privacy): WAVES' default policy (core/waves.py)
WEIGHTS = (0.4, 0.3, 0.3)


def permute_rows(x, order):
    """This rank's rows of ``x_global[order]``: ``x`` is the rank's rows
    of a batch-major tensor (all of it without a mesh), ``order`` (B,)
    the global permutation. Counts its all-reduces and their ring bytes
    in ``permute_rows.all_reduces`` and ``permute_rows.bytes``."""
    B = order.shape[0]
    axes = ("batch",) + (None,) * (x.dim() - 1)
    shape = (B,) + tuple(x.shape[1:])
    mesh = sharding.current_mesh()
    if mesh is not None:
        sizes = sharding.mesh_shape(mesh)
        spec = sharding.resolve_spec(shape, axes, mesh, sharding.LOCAL_RULES)
        for ax in sharding._entry_axes(spec[0]):
            if sizes[ax] > 1:
                permute_rows.all_reduces += 1
                permute_rows.bytes += ring_bytes(
                    "all-reduce", math.prod(shape) * x.element_size(),
                    sizes[ax])
    full = sharding.gather_global(x, axes, shape)
    return sharding.local_slice(full[order.to(full.device)], axes)


permute_rows.all_reduces = 0
permute_rows.bytes = 0.0


def make_routed_step(model, migrate_cache: bool):
    """The reference's ``routed_step`` (``routed_serve.py:49-70``) on
    tensors: routed_step(params, cache, token, pos, tbl, sens, weights,
    state) -> (logits, cache, assign, new_state). ``token`` (B_loc, 1),
    the cache and the logits are this rank's rows; ``sens`` (B,), the
    island table, ``weights`` (3,) and the router ``state`` are global
    and the same on every rank, and so are ``assign`` (B,) and
    ``new_state``. With ``migrate_cache`` the cache's rows follow their
    requests, and the cache comes back in routed order, as the
    reference's."""
    serve = make_serve_step(model)

    def routed_step(params, cache, token, pos, tbl, sens, weights, state):
        B = sens.shape[0]
        reqs = routing.pack_requests(sens, torch.zeros_like(sens),
                                     device=sens.device)
        n_islands = tbl.privacy.shape[0]
        # capacity-aware tick router fused into the serve step: the greedy
        # pass decrements bounded-island capacity per assignment, so one
        # decode step cannot oversubscribe an island group (pod)
        extra_ok = torch.ones((B, n_islands), dtype=torch.bool,
                              device=sens.device)
        assign, _, _, _, _, new_state = routing.route_batch_tick(
            tbl, reqs, weights, state, extra_ok)
        # island index -> pod id (islands 0..n/2-1 on pod 0, rest pod 1)
        pod = torch.where(assign >= 0, assign * 2 // n_islands, 0)
        order = torch.argsort(pod, stable=True)     # group requests by pod
        token_r = permute_rows(token, order)
        if migrate_cache:
            cache = [type(layer)((k, permute_rows(c, order))
                                 for k, c in layer.items())
                     for layer in cache]
        logits, cache = serve(params, cache, token_r, pos)
        inv = torch.argsort(order)
        # new_state threads the in-step load accounting to the next decode
        # step, so successive steps don't re-route against a stale snapshot
        return permute_rows(logits, inv), cache, assign, new_state

    return routed_step


def islands():
    """The routed step's four islands: two personal ones (pod 0), a
    private edge and a cloud island (pod 1)."""
    return [personal_island("laptop", latency_ms=100.0),
            personal_island("phone", latency_ms=150.0),
            edge_island("home-nas", latency_ms=300.0),
            cloud_island("cloud", latency_ms=800.0)]


def island_tables(device="cpu"):
    """(IslandTable, router state) of ``islands()`` at rest
    (``routing.pack_islands``, ``routing.pack_tide_state``)."""
    isl = islands()
    reg = IslandRegistry()
    for i in isl:
        reg.register(i, reg.attestation_token(i.island_id))
    tide = TIDE(reg)
    return (routing.pack_islands(isl, [], tide, device=device),
            routing.pack_tide_state(isl, tide, device=device))


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def build(arch: str, shape_name: str, migrate_cache: bool):
    """Lower the routed decode step of ``arch`` at ``shape_name`` on the 2
    x 16 x 16 production mesh: rank 0's step on its local meta tensors,
    counted (``dryrun.count_step``). Needs a fake process group of 512
    ranks (``fake_world``). Returns (Lowered, mesh, the step's
    permutation all-reduces and bytes)."""
    shape = SHAPES[shape_name]
    cfg = window_config(get_config(arch), shape)
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    model = get_model(cfg)
    B = shape.global_batch
    with sharding.axis_rules(mesh):
        params = local_params(model, getattr(torch, cfg.dtype))
        cache = model.init_cache(B, shape.seq_len, device="meta")
        tok = torch.empty(sharding.local_shape((B, 1), ("batch", None)),
                          dtype=torch.int32, device="meta")
        pos = torch.empty((), dtype=torch.int32, device="meta")
        tbl, state = island_tables()
        tbl = routing.IslandTable(**{f.name: _meta(getattr(tbl, f.name))
                                     for f in dataclasses.fields(tbl)})
        state = {k: _meta(v) for k, v in state.items()}
        sens = torch.empty((B,), dtype=torch.float32, device="meta")
        w = torch.empty((3,), dtype=torch.float32, device="meta")
        n0, b0 = permute_rows.all_reduces, permute_rows.bytes
        lowered = count_step(make_routed_step(model, migrate_cache), params,
                             cache, tok, pos, tbl, sens, w, state)
    permute = {"all_reduces": permute_rows.all_reduces - n0,
               "bytes": permute_rows.bytes - b0}
    return lowered, mesh, permute


def run(model, params, prompts, sens, *, max_len: int, steps: int,
        migrate_cache: bool, weights=WEIGHTS, cache_dtype=torch.bfloat16):
    """Serve ``prompts`` (B, P) int token ids with routed decode steps on
    the parameters' device, under the current mesh if one is installed:
    a full prefill of this rank's rows into a dense cache of ``max_len``
    slots in ``cache_dtype`` (the reference's bf16 by default; fp32 keeps
    a comparison of two summation orders clear of bf16 rounding flips),
    then ``steps`` routed steps (``make_routed_step``) over the
    requests' sensitivities ``sens`` (B,) and ``islands()`` from rest,
    each step's input token the greedy argmax of the previous logits.
    Returns {"logits": (steps, B_loc, V) fp32, "assign": (steps, B),
    "state": the router state after the last step, "cache": the final
    cache (in routed order with ``migrate_cache``), "step_s": each routed
    step's wall seconds (ending in a device synchronize on the card)}."""
    dev = params["embed"].device
    B, P = prompts.shape
    tbl, state = island_tables(dev)
    sens = sens.to(device=dev, dtype=torch.float32)
    w = torch.tensor(weights, dtype=torch.float32, device=dev)
    tokens = sharding.local_slice(prompts.to(dev), ("batch", None))
    cache = model.init_cache(B, max_len, dtype=cache_dtype, device=dev)
    with torch.no_grad():
        logits, cache = make_prefill_step(model)(params, cache,
                                                 tokens=tokens)
        step = make_routed_step(model, migrate_cache)
        out = {"logits": [], "assign": [], "step_s": []}
        for i in range(steps):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            pos = torch.tensor(P + i, dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            logits, cache, assign, state = step(params, cache, tok, pos,
                                                tbl, sens, w, state)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out["step_s"].append(time.perf_counter() - t0)
            out["logits"].append(logits.float())
            out["assign"].append(assign)
    out["logits"] = torch.stack(out["logits"])
    out["assign"] = torch.stack(out["assign"])
    out["state"], out["cache"] = state, cache
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--shape", default="decode_32k")
    args = ap.parse_args(argv)
    out = {}
    with fake_world(512):
        for migrate in (False, True):
            tag = "migrate_cache" if migrate else "tokens_only"
            lowered, mesh, permute = build(args.arch, args.shape, migrate)
            out[tag] = {
                "collective_bytes": lowered.collective_bytes,
                "collectives": lowered.collectives,
                "arg_gb": lowered.memory["argument_bytes"] / 2 ** 30,
                # the port's permutation collectives, where the reference
                # counts XLA's collective-permute ops
                "n_collective_permute": permute["all_reduces"],
                "permute_bytes": permute["bytes"],
                "flops": lowered.flops, "memory": lowered.memory}
            breakdown = {k: round(v["bytes"])
                         for k, v in lowered.collectives.items()}
            print(f"[{tag}] coll={lowered.collective_bytes:.3g}B "
                  f"arg={out[tag]['arg_gb']:.2f}GB "
                  f"permute_all_reduces={permute['all_reduces']} "
                  f"permute_bytes={permute['bytes']:.3g}B "
                  f"breakdown={breakdown}")
    # the reference's analytic figure (routed_serve.py:136-150): XLA
    # rotates the sharded cache (n_batch_shards - 1) times, each round
    # moving the full local shard
    shape = SHAPES[args.shape]
    cache = get_model(window_config(get_config(args.arch), shape)).init_cache(
        shape.global_batch, shape.seq_len, device="meta")
    total_cache = sum(c.numel() * c.element_size()
                      for layer in cache for c in layer.values())
    sizes = sharding.mesh_shape(mesh)
    n_batch_shards = sizes["pod"] * sizes["data"]
    local = total_cache / (n_batch_shards * sizes["model"])
    out["analytic_migration_bytes_per_chip"] = local * (n_batch_shards - 1)
    # what the port's gather moves for the cache alone, counted
    out["port_migration_bytes_per_chip"] = (
        out["migrate_cache"]["permute_bytes"]
        - out["tokens_only"]["permute_bytes"])
    print(f"migration per chip per step: reference analytic "
          f"{out['analytic_migration_bytes_per_chip']:.3g} B (XLA's "
          f"rotation), port counted "
          f"{out['port_migration_bytes_per_chip']:.3g} B (gather by "
          f"all-reduce); tokens only "
          f"{out['tokens_only']['permute_bytes']:.3g} B")
    p = RESULTS / f"routed_serve_{args.arch}_{args.shape}.json"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
