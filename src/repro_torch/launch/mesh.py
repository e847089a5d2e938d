"""Local device meshes, and the ranks that run on them.

Port of ``repro/launch/mesh.py``. ``make_local_mesh(data, model)`` is a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")`` over the process group this process has joined (rank ``d * model
+ m`` at coordinate (d, m)). The reference builds its mesh over however
many devices one process sees; the port's ranks are processes, one per
card with NCCL, or several on one card or on the CPU with gloo.

``make_production_mesh`` is the reference's 16 x 16 ("data", "model")
and 2 x 16 x 16 ("pod", "data", "model") pod meshes, over a process
group of at least 256 or 512 ranks. One process reaches that many only
on a fake group (``fake_world``): its collectives return at once and
move nothing, which is what the dry-run (``launch/dryrun.py``) traces
meta tensors on.

``RankGroup`` starts ranks with the spawn method, joins each to one
process group through a ``FileStore`` in a fresh temporary directory
(never a fixed TCP port), runs a function on every rank and collects
what each returns, with a join timeout: a rank that fails, hangs or dies
fails the group.
"""
from __future__ import annotations

import math
import os
import queue
import shutil
import tempfile
import traceback
from contextlib import contextmanager

import torch
import torch.distributed as dist


def make_local_mesh(data: int = 1, model: int = 1, device=None, *,
                    pod: int | None = None):
    """A (data, model) DeviceMesh over the initialized process group on
    ``device``'s type (None = the card); with ``pod``, a (pod, data,
    model) one, the production mesh's dims at a small size. Raises when
    the mesh needs more ranks than the group has, as the reference
    asserts on devices."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh: no process group; start the "
                           "ranks with launch.mesh.RankGroup or "
                           "torch.distributed.init_process_group")
    dims = (data, model) if pod is None else (pod, data, model)
    names = ("data", "model") if pod is None else ("pod", "data", "model")
    n = dist.get_world_size()
    if math.prod(dims) > n:
        raise ValueError(f"make_local_mesh: a {'x'.join(map(str, dims))} "
                         f"mesh needs {math.prod(dims)} ranks, the process "
                         f"group has {n}")
    dev = torch.device("cuda" if device is None else device)
    return DeviceMesh(dev.type, torch.arange(math.prod(dims)).reshape(dims),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, shape=None,
                         device=None):
    """The reference's production meshes: (16, 16) = ("data", "model")
    for one pod, (2, 16, 16) = ("pod", "data", "model") for two.
    ``shape`` overrides a pod's (data, model) factorization, which must
    hold its 256 chips. A DeviceMesh over the initialized process group
    (ranks in row-major order) on ``device``'s type (None = the card);
    raises when the group has fewer ranks than the mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    if shape is not None:
        if shape[0] * shape[1] != 256:
            raise ValueError(f"make_production_mesh: one pod = 256 chips, "
                             f"got a {shape[0]}x{shape[1]} pod")
        dims = tuple(shape)
    else:
        dims = (16, 16)
    if multi_pod:
        dims = (2,) + dims
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(dims)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise ValueError(f"make_production_mesh: a {'x'.join(map(str, dims))}"
                         f" mesh needs {n} ranks, the process group has "
                         f"{world} (join one with fake_world({n}) to trace "
                         f"meta tensors)")
    dev = torch.device("cuda" if device is None else device)
    return DeviceMesh(dev.type, torch.arange(n).reshape(dims),
                      mesh_dim_names=names)


@contextmanager
def fake_world(n: int):
    """Join a fake-backend process group of ``n`` ranks as rank 0 for the
    duration of the block, and destroy it on exit. Its collectives return
    at once and move nothing: a step on meta tensors runs through them,
    and a dispatch mode sees each one with its group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: this process is already in a "
                           "process group")
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU, or card ``rank % cards`` (one rank a
    card with NCCL; gloo ranks may share one)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def default_backend(device=None) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "gloo" if torch.device(
        "cuda" if device is None else device).type == "cpu" else "nccl"


def _rank_main(fn, rank, world, backend, store_path, args, results):
    try:
        # the ranks share the host's cores: a torch pool of every core in
        # each spins against the others
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:      # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankGroup:
    """``world`` spawned ranks in one process group running ``fn(*args)``;
    ``join`` returns each rank's result in rank order."""

    def __init__(self, fn, world: int, *, backend: str = "gloo",
                 args: tuple = ()):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="repro_torch_pg_")
        self.results = ctx.Queue()
        store = os.path.join(self._dir, "store")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(fn, r, world, backend, store, args,
                                        self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def join(self, timeout: float) -> list:
        """Every rank's result; raises if one failed, or when ``timeout``
        seconds pass without all of them (the group is then stopped)."""
        out, errors = {}, []
        try:
            while len(out) + len(errors) < len(self.procs):
                try:
                    rank, ok, val = self.results.get(timeout=timeout)
                except queue.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if p.exitcode not in (None, 0)]
                    raise TimeoutError(
                        f"RankGroup: {len(self.procs) - len(out)} of "
                        f"{len(self.procs)} ranks did not report within "
                        f"{timeout} s (dead: {dead})") from None
                if ok:
                    out[rank] = val
                else:
                    errors.append(f"rank {rank}:\n{val}")
            if errors:
                raise RuntimeError("RankGroup: " + "\n".join(errors))
            for p in self.procs:
                p.join(timeout)
            return [out[r] for r in range(len(self.procs))]
        finally:
            self.close()

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(5)
            if p.is_alive():
                p.kill()
        shutil.rmtree(self._dir, ignore_errors=True)


def run_ranks(fn, world: int, *, backend: str = "gloo", args: tuple = (),
              timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world`` spawned ranks; their results."""
    return RankGroup(fn, world, backend=backend, args=args).join(timeout)
