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
of a model too large for one card). ``--mesh`` is refused: a local
device mesh waits for the distributed slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from repro_torch import checkpoint
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model import get_model, resolve_device
from repro_torch.models.steps import make_train_step
from repro_torch.training import optim


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
                    help="dxm local mesh (not offered yet)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise SystemExit("--mesh: a local device mesh waits for the "
                         "distributed slice (ROADMAP P13); train on one "
                         "device without it")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.layers is not None:
        if not 0 < args.layers <= cfg.num_layers:
            raise SystemExit(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.num_layers}")
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = get_model(cfg)
    ocfg = optim.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                             total_steps=args.steps)
    params = model.init(seed=args.seed, dtype=getattr(torch, args.dtype),
                        device=device)
    state = optim.init_state(ocfg, params)
    data = SyntheticLM(cfg.vocab_size, args.batch, args.seq, seed=args.seed,
                       frontend=cfg.frontend, d_model=cfg.d_model,
                       num_prefix=cfg.num_prefix_tokens)

    start = 0
    if args.resume and args.ckpt_dir:
        s = checkpoint.latest_step(args.ckpt_dir)
        if s is not None:
            ck = checkpoint.restore(Path(args.ckpt_dir) / f"step_{s:08d}",
                                    {"params": params, "state": state})
            params, state = ck["params"], ck["state"]
            start = s
            data.seek(start)
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
            print(f"step {i+1:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                  f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f} "
                  f"({(time.time()-t0)/(i+1-start):.2f}s/step)")
        if args.ckpt_every and args.ckpt_dir and \
                (i + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir,
                            {"params": params, "state": state},
                            step=i + 1)
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, {"params": params, "state": state},
                        step=args.steps)
    return hist


if __name__ == "__main__":
    main()
