"""Fault-tolerant checkpointing: atomic save (write a temporary directory,
then rename), optional asynchronous write, and restore into the dtypes and
devices of a tree like the saved one.

The port of ``repro/checkpoint/checkpoint.py``, with its layout on disk:
``<dir>/step_<n>/`` holding ``arrays.npz`` (the leaves as ``leaf_<i>``, in
:mod:`repro_torch.tree` order) and ``manifest.json`` (``step``,
``n_leaves``, ``shapes``, ``dtypes``, ``extra``, and ``tree``: each leaf's
path in the port's tree, where the reference stores its JAX treedef).
bfloat16 leaves, which numpy has no type for, are stored as their uint16
bits with ``"bfloat16"`` in ``dtypes``. A synchronous save copies one leaf
at a time to the host; an asynchronous one copies every leaf first (the
port updates its tensors in place, so the thread must not read them
later) and writes in a thread. Restore reads the leaves in a few threads
(reading a stored zip member is bound by the host's copies and checksums,
which release the interpreter lock). The reference's re-sharding onto
another mesh has no counterpart on one card.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_paths, unflatten


READ_THREADS = min(8, os.cpu_count() or 1)


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` on the host as numpy (bf16 as its uint16 bits)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _write_npz(path: Path, arrays: Iterable[np.ndarray]) -> None:
    """``np.savez``'s format, written one array at a time, each array's
    bytes in one write (``np.lib.format.write_array`` copies a file
    object's in 16 MB pieces first)."""
    fmt = np.lib.format
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for i, a in enumerate(arrays):
            a = a if a.flags.c_contiguous else a.copy()   # keeps 0-d
            with z.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                fmt.write_array_header_1_0(
                    f, fmt.header_data_from_array_1_0(a))
                f.write(memoryview(a.reshape(-1).view(np.uint8)))


def save(path: str, tree, step: int, extra: Optional[Dict] = None,
         async_: bool = False) -> Optional[threading.Thread]:
    """Atomic checkpoint of ``tree`` (a nested dict/list/tuple of tensors):
    written to ``<path>/.tmp_step_<n>`` and renamed to ``step_<n>``. With
    ``async_`` the write runs in a thread, which is returned."""
    base = Path(path)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f".tmp_step_{step:08d}"
    named = leaves_with_paths(tree)
    keys = [f"leaf_{i}" for i in range(len(named))]
    manifest = {
        "step": step,
        "tree": [p for p, _ in named],
        "n_leaves": len(named),
        "shapes": {k: list(t.shape) for k, (_, t) in zip(keys, named)},
        "dtypes": {k: _dtype_name(t) for k, (_, t) in zip(keys, named)},
        "extra": extra or {},
    }

    def _write(arrays):
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        _write_npz(tmp / "arrays.npz", arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)   # atomic publish

    if async_:
        snapshot = [_host(t) for _, t in named]
        t = threading.Thread(target=_write, args=(snapshot,), daemon=True)
        t.start()
        return t
    _write(_host(t) for _, t in named)
    return None


def latest_step(path: str) -> Optional[int]:
    base = Path(path)
    if not base.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in base.glob("step_*"))
    return steps[-1] if steps else None


def restore(path: str, like_tree, step: Optional[int] = None
            ) -> Tuple[Any, Dict]:
    """The checkpoint at ``step`` (the latest by default) in the structure
    of ``like_tree``, each leaf cast to its like leaf's dtype and put on its
    device (a like leaf only lends its shape, dtype and device: an expanded
    0-d tensor will do). Returns (tree, the manifest's ``extra``)."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    d = Path(path) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    like = leaves(like_tree)
    if len(like) != manifest["n_leaves"]:
        raise ValueError(f"{d} holds {manifest['n_leaves']} leaves, the "
                         f"tree {len(like)}")

    def load(i: int) -> torch.Tensor:
        ref = like[i]
        with np.load(d / "arrays.npz") as z:
            a = z[f"leaf_{i}"]
        if manifest["dtypes"][f"leaf_{i}"] == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i} ({manifest['tree'][i]}) is "
                             f"{tuple(t.shape)}, the tree's "
                             f"{tuple(ref.shape)}")
        return t.to(device=ref.device, dtype=ref.dtype)

    with ThreadPoolExecutor(READ_THREADS) as pool:
        out = list(pool.map(load, range(len(like))))
    return unflatten(like_tree, out), manifest["extra"]


def prune(path: str, keep: int = 3) -> None:
    base = Path(path)
    steps = sorted(base.glob("step_*"))
    for p in steps[:-keep]:
        shutil.rmtree(p)
