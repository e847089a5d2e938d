"""Multi-pod dry-run: trace every (arch x input shape x mesh) on meta
tensors.

Port of ``repro/launch/dryrun.py``, with its ``lower_one``, ``run_one``,
``pairs_for`` and ``main`` and the same flags and defaults. Run as
``python -m repro_torch.launch.dryrun``. Where the reference lowers and
compiles one SPMD program for 256 or 512 devices, the port "lowers" by
running rank 0's step once: its step built as the reference's
``build_step`` builds it, on meta tensors of rank 0's local shapes, under
the production mesh (``launch.mesh.make_production_mesh``) on a fake
process group of the mesh's size (``launch.mesh.fake_world``), inside
counting modes. Meta tensors carry shapes and dtypes and no data; the
kernel wrappers take their plain versions for them (no launch), and the
fake group's collectives return at once.

Each record keeps the reference's keys, counted as follows, and adds
two of its own:

* ``flops``: ``FlopCounterMode``'s count for the rank (matmuls and
  convolutions; the plain attention versions compute every (query, key)
  pair, where the kernels skip masked tiles);
* ``bytes_accessed``: the sum of every dispatched op's input and output
  bytes (views and collectives excluded), an unfused upper bound;
* ``memory``: ``argument_bytes`` (the local tensors passed in; a train
  step's batch at the rank's rows, the share its step slices out),
  ``output_bytes`` (the tensors returned) and ``temp_bytes`` (the peak
  bytes of storages the step allocated and did not return, from a
  dispatch-mode tracker of meta storages: the plain versions'
  intermediates, such as a full score matrix, included);
  ``generated_code_bytes`` is ``None``;
* ``collectives``: per collective kind, ``{count, bytes}``, each c10d op
  counted with the reference's ring estimate (``ring_bytes``, its
  ``parse_collectives``) for the op's own group size, and their sum in
  ``collective_bytes``;
* ``param_bytes_placed`` (port only): the bytes of the weights rank 0
  of the port holds, read from the local tensors the step ran on: every
  weight's slice as ``sharding.placed_axes`` places it (the reference's
  rules; under ``--fsdp``, ``apply_fsdp``'s split over the data axes
  too);
* ``param_bytes_by_rules`` (port only): the weights a device holds under
  the reference's rules, from the shapes alone (``param_bytes``; under
  ``--fsdp`` ``apply_fsdp`` decided on the reference's stacked layout),
  which is what the reference places. The two are equal;
* ``fsdp_collectives`` (port only, under ``--fsdp``): the gathers of the weights
  split over the data axes (``sharding.fsdp_gather``) and the sums of
  their gradients, each ``{count, bytes}``: the port runs both as
  all-reduces of a flat buffer a layer (counted under ``all-reduce``
  too), where the reference's HLO has all-gathers and reduce-scatters
  (``note``).

``transcendentals``, ``compile_s`` and ``hlo_bytes`` have no counterpart
here and are ``None``, each with its reason in ``note``. A train step
takes the factored second moment for configs of 64 experts or more, as
the reference's (``models.steps.init_opt_state``, in the reference's
stacked layout). The long-context sliding-window
variant runs with ``cfg.attn_window`` set to ``SLIDING_WINDOW``: the
port's steps take no ``window`` argument.

Records go to ``build/dryrun/`` by default (git ignores ``build/``).
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import sharding
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.specs import (decode_window, input_specs,
                                      needs_sliding_window)
from repro_torch.models.model import get_model
from repro_torch.models.steps import (init_opt_state, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.training import optim

RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"

NOTE = {
    "bytes_accessed": "sum of each dispatched op's input and output bytes "
                      "(views and collectives excluded): an unfused upper "
                      "bound",
    "temp_bytes": "peak bytes of the storages the step allocated and did "
                  "not return, the plain versions' intermediates included",
    "transcendentals": "not counted: no dispatch-level counter",
    "compile_s": "nothing is compiled: the step runs once on meta tensors",
    "hlo_bytes": "no HLO: the step runs eagerly",
    "generated_code_bytes": "no generated code",
    "collectives": "per c10d op, the reference's ring estimate "
                   "(parse_collectives) for the op's group size",
    "param_bytes_placed": "the weights rank 0 holds: each leaf's slice "
                          "as sharding.placed_axes places it",
}
# an --fsdp record's gathers and gradient sums
GATHER_NOTE = ("gathers: an all-reduce of a zero-filled flat buffer a layer "
             "over each data axis, where the reference's HLO has an "
             "all-gather; reduce_scatters: an all-reduce of the layer's "
             "fp32 gradients and a narrow to the rank's slice, where it "
             "has a reduce-scatter. Both also counted under all-reduce; "
             "bytes: the reference's ring estimate for the all-reduces "
             "run")

# ------------------------------------------------------ collective bytes

# c10d op -> the reference's collective kind (HLO op name)
C10D_KINDS = {"allreduce_": "all-reduce", "allgather_": "all-gather",
              "_allgather_base_": "all-gather",
              "allgather_into_tensor_coalesced_": "all-gather",
              "reduce_scatter_": "reduce-scatter",
              "_reduce_scatter_base_": "reduce-scatter",
              "reduce_scatter_tensor_coalesced_": "reduce-scatter",
              "alltoall_": "all-to-all", "alltoall_base_": "all-to-all"}


def ring_bytes(kind: str, out_bytes: float, n: int) -> float:
    """Per-device bytes one collective of ``kind`` moves, for a result of
    ``out_bytes`` over a group of ``n``: the reference's ring estimates
    (``repro/launch/dryrun.py:84-96``)."""
    frac = (n - 1) / max(n, 1)
    if kind == "all-reduce":
        return 2 * out_bytes * frac
    if kind == "all-gather":
        return out_bytes * frac
    if kind == "reduce-scatter":
        return out_bytes * n * frac
    if kind == "all-to-all":
        return out_bytes * frac
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(f"ring_bytes: no estimate for {kind!r}")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors of a tree of containers and dataclasses (the island
    table)."""
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif dataclasses.is_dataclass(t):
            out += _tensors([getattr(t, f.name)
                             for f in dataclasses.fields(t)])
    return out


def _group_size(func, args) -> int:
    for a, arg in zip(args, func._schema.arguments):
        if "ProcessGroup" in str(arg.type):
            return dist.ProcessGroup.unbox(a).size()
    raise ValueError(f"{func}: no process group argument")


class StepCounter(TorchDispatchMode):
    """Counts what one run of a step dispatches: input and output bytes
    of every op that is neither a view nor a collective, each c10d
    collective (kind, count, ring bytes), and the storages the step
    allocates, for the peak of those it did not return. ``known`` holds
    the tensors passed in: their storages are arguments, not
    intermediates."""

    def __init__(self, known=()):
        super().__init__()
        self.bytes_accessed = 0
        self.collectives: dict = {}
        self._known = {id(t.untyped_storage()) for t in _tensors(known)}
        self._live: dict = {}       # id(storage) -> (token, nbytes)
        self._events: list = []     # (token, +/- nbytes) in order
        self._tokens = itertools.count()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            kind = C10D_KINDS.get(func._opname)
            if kind is None:
                raise ValueError(f"StepCounter: no ring estimate for {func}")
            # the result is the op's first argument (the tensors reduced
            # in place, or the base forms' output buffer)
            res = _tensors(args[0])
            moved = ring_bytes(kind, sum(_nbytes(t) for t in res),
                               _group_size(func, args))
            rec = self.collectives.setdefault(kind, {"count": 0,
                                                     "bytes": 0.0})
            rec["count"] += 1
            rec["bytes"] += moved
            return out
        if not func.is_view:
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self._track(t.untyped_storage())
        return out

    def _track(self, st):
        key = id(st)
        if key in self._known or key in self._live:
            return
        token = next(self._tokens)
        self._live[key] = (token, st.nbytes())
        self._events.append((token, st.nbytes()))
        weakref.finalize(st, self._free, key).atexit = False

    def _free(self, key):
        token, n = self._live.pop(key)
        self._events.append((token, -n))

    def temp_bytes(self, outputs) -> int:
        """Peak live bytes of the step's own storages, less the ones it
        returned (``outputs``)."""
        ret = {self._live[id(t.untyped_storage())][0]
               for t in _tensors(outputs)
               if id(t.untyped_storage()) in self._live}
        live = peak = 0
        for token, n in self._events:
            if token not in ret:
                live += n
                peak = max(peak, live)
        return peak

    @property
    def collective_bytes(self) -> float:
        return sum(r["bytes"] for r in self.collectives.values())


@dataclasses.dataclass
class Lowered:
    """What one counted run of a step recorded (the port's stand-in for
    the reference's lowered and compiled program)."""
    flops: float
    bytes_accessed: float
    memory: dict
    collectives: dict
    collective_bytes: float


def count_step(fn, *args) -> Lowered:
    """Run ``fn(*args)`` once under ``FlopCounterMode`` and a
    ``StepCounter``."""
    counter = StepCounter(known=args)
    with FlopCounterMode(display=False) as flops, counter:
        out = fn(*args)
    return Lowered(
        flops=float(flops.get_total_flops()),
        bytes_accessed=float(counter.bytes_accessed),
        memory={"argument_bytes": sum(_nbytes(t) for t in _tensors(args)),
                "output_bytes": sum(_nbytes(t) for t in _tensors(out)),
                "temp_bytes": counter.temp_bytes(out),
                "generated_code_bytes": None},
        collectives=counter.collectives,
        collective_bytes=counter.collective_bytes)


# ------------------------------------------------------------- the dry run

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def local_inputs(inp: dict) -> dict:
    """Rank-local meta stand-ins of global inputs: the leading batch dim
    split over the batch axes (a scalar as it is)."""
    return {k: _meta(sharding.local_shape(
        v.shape, ("batch",) + (None,) * (v.dim() - 1)) if v.dim() else (),
        v.dtype) for k, v in inp.items()}


def local_params(model, dtype):
    """Meta stand-ins of the weights rank 0 of the port holds."""
    return optim.tree_map(
        lambda s, ax: _meta(sharding.local_shape(s.shape, ax), s.dtype),
        model.abstract(dtype), sharding.placed_axes(model))


def param_bytes(model, dtype, mesh, *, fsdp=False, rules=None) -> int:
    """Bytes of the weights a device holds under ``rules`` (None: the
    port's ``LOCAL_RULES``; ``sharding.DEFAULT_RULES``: the reference's
    placement by ``Model.axes()``, with ``apply_fsdp`` under ``fsdp``,
    decided on the reference's stacked layout: ``sharding.placed_axes``).
    Shapes only: ``lower_one`` reads what the rank holds from its
    tensors."""
    abstract = model.abstract(dtype)
    axes = sharding.placed_axes(model, mesh, fsdp=fsdp)
    return sum(optim.tree_leaves(optim.tree_map(
        lambda s, ax: math.prod(sharding.local_shape(
            tuple(s.shape), tuple(ax), mesh, rules)) * s.element_size(),
        abstract, axes)))


def window_config(cfg, shape):
    """``cfg`` with the decode window of ``shape`` as its attention
    window (the sliding-window variant): the port's steps read the
    window from the config."""
    window = decode_window(cfg, shape)
    if window != cfg.attn_window:
        cfg = dataclasses.replace(cfg, attn_window=window)
    return cfg


def build_step(cfg, shape, model, opt_dtype="float32"):
    """(kind, step, global abstract inputs, AdamW config or None,
    window), as the reference's ``build_step``; the model reads the
    window from its config."""
    kind, inp = input_specs(cfg, shape)
    window = decode_window(cfg, shape)
    if kind == "train":
        opt_cfg = optim.AdamWConfig(
            # 1T-class MoE: the factored second moment
            factored=cfg.num_experts >= 64,
            state_dtype=opt_dtype)
        return kind, make_train_step(model, opt_cfg, remat=True), inp, \
            opt_cfg, window
    if kind == "prefill":
        return kind, make_prefill_step(model), inp, None, window
    return kind, make_serve_step(model), inp, None, window


def lower_one(arch: str, shape_name: str, multi_pod: bool,
              mesh_shape=None, fsdp=False, kv_dtype="bfloat16",
              opt_dtype="float32"):
    """Trace rank 0's step for one combination; returns (Lowered,
    n_devices, kind, window). Needs a process group of at least the
    mesh's size (``fake_world``)."""
    shape = SHAPES[shape_name]
    cfg = window_config(get_config(arch), shape)
    mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape,
                                device="cpu")
    n_dev = math.prod(sharding.mesh_shape(mesh).values())
    model = get_model(cfg)
    dtype = getattr(torch, cfg.dtype)

    fsdp_counts = sharding.fsdp_gather.counts
    fsdp_counts.clear()
    with sharding.axis_rules(mesh, fsdp=fsdp):
        kind, step, inp, opt_cfg, window = build_step(cfg, shape, model,
                                                      opt_dtype=opt_dtype)
        params = local_params(model, dtype)
        if kind == "train":
            opt_state = init_opt_state(model, opt_cfg, params)
            lowered = count_step(step, params, opt_state, inp)
            # the rank's argument is its rows of the batch (the step
            # slices them out of the global batch it takes)
            lowered.memory["argument_bytes"] += sum(
                _nbytes(v) for v in local_inputs(inp).values()) - sum(
                _nbytes(v) for v in inp.values())
        elif kind == "prefill":
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     device="meta")
            loc = local_inputs(inp)
            lowered = count_step(
                lambda p, c, tokens=None, embeddings=None: step(
                    p, c, tokens=tokens, embeddings=embeddings),
                params, cache, loc.get("tokens"), loc.get("embeddings"))
        else:                                  # decode
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     dtype=getattr(torch, kv_dtype),
                                     device="meta")
            loc = local_inputs(inp)
            lowered = count_step(step, params, cache, loc["token"],
                                 loc["pos"])
        lowered.memory["param_bytes_placed"] = sum(
            _nbytes(t) for t in optim.tree_leaves(params))
        lowered.memory["param_bytes_by_rules"] = param_bytes(
            model, dtype, mesh, fsdp=fsdp, rules=sharding.DEFAULT_RULES)
        if fsdp:
            lowered.memory["fsdp_collectives"] = {kind: {"count": 0, "bytes": 0.0}
                                      for kind in ("gathers",
                                                   "reduce_scatters")}
            for (kind, n), (count, nbytes) in fsdp_counts.items():
                rec = lowered.memory["fsdp_collectives"][kind]
                rec["count"] += count
                rec["bytes"] += ring_bytes("all-reduce", nbytes, n)
    return lowered, n_dev, kind, window


def mesh_name(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape is not None:
        base = f"pod{mesh_shape[0]}x{mesh_shape[1]}"
        return ("pod2x" + base[3:]) if multi_pod else base
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
            mesh_shape=None, fsdp=False, kv_dtype="bfloat16", tag_extra="",
            opt_dtype="float32"):
    name = mesh_name(multi_pod, mesh_shape)
    tag = f"{arch}__{shape_name}__{name}{tag_extra}"
    out_path = out_dir / f"{tag}.json"
    if out_path.exists():
        prev = json.loads(out_path.read_text())
        if prev.get("ok"):
            print(f"[skip] {tag}")
            return True
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "fsdp": fsdp, "kv_dtype": kv_dtype,
           "variant": ("sliding-window" if needs_sliding_window(cfg, shape)
                       else "native")}
    try:
        lowered, n_dev, kind, window = lower_one(
            arch, shape_name, multi_pod, mesh_shape=mesh_shape, fsdp=fsdp,
            kv_dtype=kv_dtype, opt_dtype=opt_dtype)
        t_lower = time.time() - t0
        mem = lowered.memory
        rec.update({
            "kind": kind, "window": window, "n_devices": n_dev,
            "lower_s": round(t_lower, 1), "compile_s": None,
            "flops": lowered.flops,
            "bytes_accessed": lowered.bytes_accessed,
            "transcendentals": None,
            "memory": {k: mem[k] for k in ("argument_bytes", "output_bytes",
                                           "temp_bytes",
                                           "generated_code_bytes")},
            "collectives": lowered.collectives,
            "collective_bytes": lowered.collective_bytes,
            "hlo_bytes": None,
            "param_bytes_placed": mem["param_bytes_placed"],
            "param_bytes_by_rules": mem["param_bytes_by_rules"],
            **({"fsdp_collectives": mem["fsdp_collectives"]}
               if fsdp else {}),
            "note": {**NOTE, **({"fsdp_collectives": GATHER_NOTE}
                                if fsdp else {})},
        })
        rec["ok"] = True
        print(f"[ok]   {tag}  lower={t_lower:.1f}s "
              f"flops={rec['flops']:.3g} coll={rec['collective_bytes']:.3g}B")
    except Exception as e:    # one failed combination, recorded
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {tag}: {rec['error'][:200]}")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec.get("ok", False)


def pairs_for(arch: str):
    for sname in SHAPES:
        yield arch, sname


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--mesh-shape", default=None,
                    help="per-pod data x model, e.g. 64x4 (perf experiments)")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3-style weight sharding over the data axis")
    ap.add_argument("--kv-dtype", default="bfloat16",
                    help="decode cache dtype (e.g. float8_e4m3fn)")
    ap.add_argument("--tag", default="", help="extra tag for the result file")
    ap.add_argument("--opt-dtype", default="float32",
                    help="optimizer state dtype (bfloat16 halves m/v memory)")
    args = ap.parse_args(argv)
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)
    out_dir = Path(args.out)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_ok = n_fail = 0
    t0 = time.time()
    for mp in meshes:
        with fake_world(512 if mp else 256):
            for arch in archs:
                for sname in shapes:
                    ok = run_one(arch, sname, mp, out_dir,
                                 mesh_shape=mesh_shape, fsdp=args.fsdp,
                                 kv_dtype=args.kv_dtype, tag_extra=args.tag,
                                 opt_dtype=args.opt_dtype)
                    n_ok += ok
                    n_fail += (not ok)
    print(f"done: {n_ok} ok, {n_fail} failed in {time.time() - t0:.1f} s")
    return n_fail


if __name__ == "__main__":
    main()
