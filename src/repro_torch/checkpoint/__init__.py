"""Tree checkpointing: an npz payload and a json manifest.

Port of ``repro/checkpoint/__init__.py`` on nested dicts and lists of
tensors, with the reference's on-disk layout: ``step_XXXXXXXX/
arrays.npz`` and ``manifest.json``, each leaf keyed by its path (dict key
or list index, joined by ``/``), bf16 stored as fp32 and the manifest
naming the leaf's own dtype. The save is atomic (a temporary file
renamed into place). A file either package writes for the same tree
structure is read by the other. ``restore`` reads into the structure of a
``like`` tree, validating shapes, and gives each leaf ``like``'s dtype and
device.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch


def _flatten_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save(path, tree, step: int | None = None, extra: dict | None = None):
    path = Path(path)
    if step is not None:
        path = path / f"step_{step:08d}"
    path.mkdir(parents=True, exist_ok=True)
    flat = {k: torch.as_tensor(v).detach().cpu()
            for k, v in _flatten_with_paths(tree)}
    manifest = {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                for k, v in flat.items()}
    if extra:
        manifest["__extra__"] = extra
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    os.close(fd)
    written = tmp + ".npz"  # np.savez appends .npz to non-.npz names
    np.savez(tmp, **{k: (v.float() if v.dtype == torch.bfloat16 else v)
                     .numpy() for k, v in flat.items()})
    os.replace(written, path / "arrays.npz")
    os.unlink(tmp)
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return path


def restore(path, like):
    """Restore into the structure of ``like`` (shapes validated)."""
    path = Path(path)
    data = np.load(path / "arrays.npz")
    manifest = json.loads((path / "manifest.json").read_text())

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, prefix + (str(i),)) for i, v in enumerate(node)]
        key = "/".join(prefix)
        arr = data[key]
        want = manifest[key]
        assert list(arr.shape) == want["shape"], (key, arr.shape, want)
        like_t = torch.as_tensor(node)
        # a copy in torch's own allocation (aligned as a fresh tensor is),
        # never a view of numpy's buffer
        return torch.tensor(arr, dtype=like_t.dtype, device=like_t.device)

    return build(like, ())


def latest_step(root) -> int | None:
    root = Path(root)
    if not root.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in root.iterdir()
                   if p.name.startswith("step_"))
    return steps[-1] if steps else None
