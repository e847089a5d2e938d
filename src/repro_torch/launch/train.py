"""Training driver: ``python -m repro_torch.launch.train --arch smollm-135m
--smoke --steps 200``.

Port of ``repro/launch/train.py``. Runs the substrate end to end: config
-> model -> data pipeline (``SyntheticLM``) -> AdamW -> checkpointing,
with the same flags and the same ``hist`` (one metrics dict each
``--log-every`` steps and at the last). ``--smoke`` trains the reduced
config. ``--device`` picks where the model trains: the card by default,
``cpu`` for the kernels' plain versions. Every family trains on the
card: attention through K4 and its backward kernel, Mamba-2's SSD through
K5 and its backward, the RG-LRU recurrence through K6 and its backward.
Two options the reference does not have: ``--remat`` recomputes each
pattern group's forward in the backward (``Model.forward(remat=True)``,
as the reference's train step can), and ``--layers N`` trains the
config's first N layers (its pattern continued, every width kept: a cut
of a model too large for one card).

``--mesh dxm`` trains under a (data, model) mesh (``launch.mesh``): the
global batch is split over "data" (or held whole by every rank where
"data" does not divide it, as the reference replicates it), an MoE
block's experts over "model"
(the train step's data-parallel gradient reduction and the
expert-parallel MoE, ``models.steps``, ``models.moe``). Outside a process
group the launcher starts the d * m ranks itself (spawned, joined
through a ``FileStore``), so the reference's command line works
unchanged; it then returns rank 0's ``hist``, and only rank 0 prints.
``--backend`` is gloo on the CPU and NCCL on the card (one rank a card)
by default; gloo on the card runs several ranks on one card. Checkpoints
are written in the global layout (every shard gathered, rank 0 writes),
so a run with ``--mesh`` resumes one without it, and the reverse. Under
the mesh each rank holds its slice of every weight by the reference's
rules (``sharding.LOCAL_RULES``: heads, ff, vocab, ssm_heads and lru
tensor-parallel over "model", experts over "model"). ``--fsdp`` (only
with ``--mesh``, the counterpart of the reference's dry-run flag) adds
the reference's ZeRO-3 placement: each large weight, and its AdamW
moments, split over "data" as ``apply_fsdp`` places it on the
reference's stacked layout (``sharding.placed_axes``), gathered a layer
at a time in the step. The checkpoint carries the AdamW state as
``models.steps.init_opt_state`` lays it out (a factored one with its
groups' statistics), every shard gathered by its placement.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import checkpoint, sharding
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import (default_backend, make_local_mesh,
                                     rank_device, run_ranks)
from repro_torch.models.model import get_model, resolve_device
from repro_torch.models.steps import (init_opt_state, make_train_step,
                                      state_layout)
from repro_torch.training import optim

# the spawned ranks' join timeout (seconds)
RANK_TIMEOUT = 3600.0


def parse_mesh(text):
    """'dxm' -> (d, m)."""
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {text!r}: expected dxm, e.g. 2x1") from None
    if d < 1 or m < 1:
        raise SystemExit(f"--mesh {text!r}: both sizes must be >= 1")
    return d, m


def cut_config(cfg, layers):
    """``cfg`` cut to its first ``layers`` layers (``--layers``): the
    pattern continued, every width and the whole vocabulary kept."""
    if not 0 < layers <= cfg.num_layers:
        raise SystemExit(f"--layers {layers}: {cfg.name} has "
                         f"{cfg.num_layers}")
    return dataclasses.replace(cfg, num_layers=layers)


def _global(tree, axes, shapes, mesh):
    """Every shard gathered: the tree in the global layout."""
    return optim.tree_map(
        lambda t, ax, s: sharding.gather_global(t, ax, s.shape, mesh),
        tree, axes, shapes)


def _local(tree, axes, like):
    """This rank's slices of a global tree, on ``like``'s devices."""
    return optim.tree_map(
        lambda t, ax, l: sharding.local_slice(t, ax).to(l.device), tree,
        axes, like)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer group's forward in the "
                         "backward")
    ap.add_argument("--layers", type=int, default=None,
                    help="train the config's first N layers")
    ap.add_argument("--mesh", default=None,
                    help="dxm local mesh, e.g. 2x1: d * m ranks")
    ap.add_argument("--fsdp", action="store_true",
                    help="with --mesh: split weights and AdamW state over "
                         "the data axis as the reference's dry-run --fsdp "
                         "places them (ZeRO-3)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="the mesh's process-group backend (default: "
                         "nccl on the card, gloo on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    mesh = None
    if args.fsdp and not args.mesh:
        raise SystemExit("--fsdp splits weights over the mesh's data axis: "
                         "pass --mesh too")
    if args.mesh:
        d, m = parse_mesh(args.mesh)
        if not dist.is_initialized():
            backend = args.backend or default_backend(args.device)
            if backend == "nccl" and torch.cuda.is_available() and \
                    torch.cuda.device_count() < d * m:
                raise SystemExit(
                    f"--mesh {args.mesh}: NCCL takes one rank a card and "
                    f"{torch.cuda.device_count()} cards are visible; pass "
                    f"--backend gloo to run the ranks on shared cards")
            return run_ranks(main, d * m, backend=backend,
                             args=(sys.argv[1:] if argv is None else argv,),
                             timeout=RANK_TIMEOUT)[0]
        mesh = make_local_mesh(d, m, args.device)
        device = rank_device(args.device)
    else:
        device = resolve_device(args.device)
    with (sharding.axis_rules(mesh, fsdp=args.fsdp) if mesh is not None
          else contextlib.nullcontext()):
        return _train(args, device, mesh)


def _train(args, device, mesh):
    lead = mesh is None or dist.get_rank() == 0
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = cut_config(cfg, args.layers)
    model = get_model(cfg)
    ocfg = optim.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                             total_steps=args.steps)
    params = model.init(seed=args.seed, dtype=getattr(torch, args.dtype),
                        device=device)
    state = init_opt_state(model, ocfg, params)
    data = SyntheticLM(cfg.vocab_size, args.batch, args.seq, seed=args.seed,
                       frontend=cfg.frontend, d_model=cfg.d_model,
                       num_prefix=cfg.num_prefix_tokens)

    pax, shapes = sharding.placed_axes(model), model.abstract()
    sax, sshapes = state_layout(model, ocfg)

    def save(step):       # the global layout: every shard gathered
        checkpoint_tree = {
            "params": _global(params, pax, shapes, mesh),
            "state": {**_global({k: state[k] for k in sax}, sax, sshapes,
                                mesh), "step": state["step"]}}
        if lead:
            checkpoint.save(args.ckpt_dir, checkpoint_tree, step=step)
        if mesh is not None:
            dist.barrier()

    start = 0
    if args.resume and args.ckpt_dir:
        s = checkpoint.latest_step(args.ckpt_dir)
        if s is not None:
            # read the global layout on the host, keep this rank's slices
            like = optim.tree_map(
                lambda t, g: torch.empty(g.shape, dtype=t.dtype),
                {"params": params, **{k: state[k] for k in sax}},
                {"params": shapes, **sshapes})
            g = checkpoint.restore(
                Path(args.ckpt_dir) / f"step_{s:08d}",
                {"params": like.pop("params"),
                 "state": {**like, "step": state["step"].cpu()}})
            params = _local(g["params"], pax, params)
            state = {**_local({k: g["state"][k] for k in sax}, sax,
                              {k: state[k] for k in sax}),
                     "step": g["state"]["step"].to(device)}
            start = s
            data.seek(start)
            if lead:
                print(f"resumed from step {s}")

    step_fn = make_train_step(model, ocfg, remat=args.remat)
    hist = []
    t0 = time.time()
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.next_batch().items()}
        params, state, metrics = step_fn(params, state, batch)
        if (i + 1) % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            hist.append({"step": i + 1, **m})
            if lead:
                print(f"step {i+1:5d} loss={m['loss']:.4f} "
                      f"ce={m['ce']:.4f} lr={m['lr']:.2e} "
                      f"gnorm={m['grad_norm']:.2f} "
                      f"({(time.time()-t0)/(i+1-start):.2f}s/step)")
        if args.ckpt_every and args.ckpt_dir and \
                (i + 1) % args.ckpt_every == 0:
            save(i + 1)
    if args.ckpt_dir:
        save(args.steps)
    return hist


if __name__ == "__main__":
    main()
