"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``build/repro_torch/`` at the repository root. The file name carries a
hash of the sources, so an edited kernel rebuilds and an unchanged one
loads from disk. ``build_all`` starts one ``nvcc`` per source at once.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("paged_attention", "chunked_prefill", "decode_attention",
           "flash_attention", "ssd_chunk", "rglru_scan",
           "flash_attention_bwd", "ssd_chunk_bwd", "rglru_scan_bwd")
# the attention kernels' (K1-K4) compiled head_dim variants: those of the
# configs the port runs (smollm-135m, musicgen-large 64; qwen3, glm4 128;
# recurrentgemma-9b, paligemma-3b 256; their .reduced() widths 32)
HEAD_DIMS = (32, 64, 128, 256)
# the devices whose tensors take a kernel's plain version (``ref.py``):
# the CPU, and meta tensors, for abstract evaluation (shapes and dtypes
# only: no data, no launch, no launch counted). A CUDA tensor launches
# the kernel or raises; any other device raises.
PLAIN_DEVICES = ("cpu", "meta")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> loaded ctypes library; name -> ptxas report of its build
_LIBS: dict = {}
BUILD_LOGS: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start the build of one kernel; None when it is already on disk."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _wait(name: str, job) -> str | None:
    """Wait for one build; returns nvcc's log if it failed."""
    if job is None:
        return None
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        return log
    os.replace(tmp, out)
    return None


def _finish(name: str, job):
    log = _wait(name, job)
    if log is not None:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")


def build_all(names=KERNELS):
    """Build every named kernel, one nvcc process each, all at once; every
    build is waited for before a failure is raised."""
    jobs = {n: _start(n) for n in names}
    failed = {n: _wait(n, job) for n, job in jobs.items()}
    logs = [f"nvcc failed for {n}.cu:\n{log}"
            for n, log in failed.items() if log is not None]
    if logs:
        raise RuntimeError("\n".join(logs))


def refuse_grad(name, tensors, when):
    """Raise where autograd would differentiate kernel ``name``: a CUDA
    launch fills its output through a raw pointer, so the output carries
    no ``grad_fn`` and every gradient before it would be dropped without
    a word. ``when`` says where its backward kernel comes, if anywhere.
    The plain versions (CPU tensors) stay differentiable."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward kernel on the card ({when}); an input "
            f"requires grad, and its gradient would be dropped silently. "
            f"Run it under torch.no_grad(), or train on the CPU")


def check_paged_args(q, k_pages, v_pages, block_table, lens, q_rank):
    """Validate the tensors a paged attention kernel reads (raises
    ValueError); returns (q dtype code, page dtype code)."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    ts = (q, k_pages, v_pages, block_table, lens)
    if any(t.device != q.device for t in ts):
        raise ValueError("paged attention: all tensors must share q's device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("paged attention: tensors must be contiguous")
    if q.dtype not in codes or k_pages.dtype not in codes:
        raise ValueError(f"paged attention: q {q.dtype} / pages "
                         f"{k_pages.dtype} must be float32 or bfloat16")
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape:
        raise ValueError("paged attention: k/v pages differ in dtype/shape")
    if block_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("paged attention: block_table and lengths must "
                         "be int32")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    if q.dim() != q_rank or k_pages.dim() != 4 or k_pages.shape[3] != D \
            or H % k_pages.shape[2]:
        raise ValueError(f"paged attention: bad shapes q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged attention: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged attention: pages must be 16-byte aligned")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or lens.shape != (B,):
        raise ValueError(f"paged attention: block_table "
                         f"{tuple(block_table.shape)} / lengths "
                         f"{tuple(lens.shape)} do not match batch {B}")
    return codes[q.dtype], codes[k_pages.dtype]


def check_dense_args(name, q, k, v, ints, q_rank):
    """Validate the tensors a dense-cache attention kernel reads: q of
    rank ``q_rank``, k/v (B, S, Hkv, D), and the int32 tensors ``ints``
    (raises ValueError); returns (q dtype code, k/v dtype code)."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    ts = (q, k, v, *ints)
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: all tensors must share q's device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: tensors must be contiguous")
    if q.dtype not in codes or k.dtype not in codes:
        raise ValueError(f"{name}: q {q.dtype} / k {k.dtype} must be "
                         f"float32 or bfloat16")
    if v.dtype != k.dtype or v.shape != k.shape:
        raise ValueError(f"{name}: k and v differ in dtype or shape")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError(f"{name}: lengths must be int32")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    if q.dim() != q_rank or k.dim() != 4 or k.shape[0] != B \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: k/v must be 16-byte aligned")
    return codes[q.dtype], codes[k.dtype]


@functools.lru_cache(maxsize=256)
def prefill_grid(name, B, T, H, Hkv):
    """(blocks of one key range, query tokens a block) of the prefill walk
    (K2, K4) that library ``name`` launches at these shapes, from its
    launcher's own grid (``prefill_walk_grid`` in csrc/prefill_walk.cuh)."""
    out = (ctypes.c_int * 2)()
    load_entry(name, "prefill_walk_grid",
               [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])(
        B, T, H, Hkv, out)
    return out[0], out[1]


@functools.lru_cache(maxsize=256)
def decode_attrs(name, entry, q_code, kv_code, D, B, H, Hkv):
    """The decode walk (K1, K3) instantiation that library ``name`` runs at
    these dtypes and shapes, from its C entry ``entry``
    (``decode_walk_attrs`` in csrc/decode_walk.cuh): (registers, dynamic
    shared memory, local bytes, resident blocks an SM, key tile, blocks of
    one key range). The wrappers plan the split from the last two."""
    out = (ctypes.c_int * 6)()
    rc = load_entry(name, entry,
                    [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])(
        q_code, kv_code, D, B, H, Hkv, out)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: cudaError {rc}")
    return tuple(out)


def prefill_split(blocks, walk, sms, tile=64):
    """Key ranges each walk of the attention kernels is split into (a q
    tile's for the prefill walk, K2 and K4; a row's for the decode walk,
    K1 and K3, at its 32-key ``tile``), for a grid of ``blocks`` a range:
    1 where that already gives two blocks an SM, else enough ranges for
    that, at most one per ``tile`` keys of the longest walk (``walk`` keys,
    from the shapes: no device read) and at most 16. A range past a walk's
    end is empty: it costs a block and adds exactly nothing."""
    target = 2 * sms
    if blocks >= target:
        return 1
    return max(1, min(-(-target // blocks), -(-walk // tile), 16))


def split_scratch(n_split, q):
    """A split walk's fp32 scratch for q (..., H, D): the ranges'
    unnormalised outputs (n_split, ..., H, D) and their (m, l) (n_split,
    ..., H, 2); null pointers for one range."""
    import torch
    if n_split == 1:
        return None, None
    part_o = torch.empty(n_split, *q.shape, device=q.device,
                         dtype=torch.float32)
    part_ml = torch.empty(n_split, *q.shape[:-1], 2, device=q.device,
                          dtype=torch.float32)
    return part_o, part_ml


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def load_entry(name: str, entry: str, argtypes):
    """The C entry ``entry`` of kernel ``name`` (built on first use), with
    its ``argtypes`` declared and an ``int`` (cudaError_t) result."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
