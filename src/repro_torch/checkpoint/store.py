"""Checkpointing of trees of tensors: atomic, async, restart-safe.

Port of ``repro/checkpoint/store.py``, with its layout per step::

    <dir>/step_000042/
        manifest.json      # leaf paths, shapes, dtypes
        arr_00000.npz ...  # leaf payloads, chunked

Leaves are flattened in sorted key order with ``"/"``-joined paths
(:func:`repro_torch.tree.tree_flatten_with_paths`), the order and names
``jax.tree_util.tree_flatten_with_path`` gives the reference, so leaf
order, chunk files and manifest are the same from either package.  npz
has no bfloat16: a bf16 leaf is written as its ``uint16`` bits with
``"bfloat16"`` in the manifest, as the reference writes an ``ml_dtypes``
array, and read back through the same view, so neither ``jax`` nor
``ml_dtypes`` is needed.  A checkpoint written by either package restores
in the other bit for bit.

Restore rebuilds the tree on the host and puts each leaf on its target
tensor's device, in the target's dtype; with ``shardings`` (a tree of
layouts: anything with ``device_mesh`` and ``placements``, such as
``parallel.sharding.Sharding`` or a DTensor) each leaf is laid out on that
mesh, each rank keeping its slice.  Checkpoints hold full values, so one
written on a mesh restores onto another, or onto one device (the
reference's elastic restore, ``repro/checkpoint/store.py:106-140``).
:class:`AsyncCheckpointer` snapshots to host memory synchronously and
writes on a background thread, keeping the save off the train step's
critical path.  In a ``torch.distributed`` world every rank takes the full
value of each DTensor leaf on the main thread (a collective), only rank 0
writes, and all ranks meet at a barrier before the next save, at the end
(``wait``) and before a restore through :class:`CheckpointManager`.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.sharding import is_dtensor
from ..tree import tree_flatten_with_paths, tree_map, tree_unflatten


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as host numpy, bf16 as its ``uint16`` bits (what npz
    stores); the manifest's dtype names what it holds."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _decode(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored payload as a CPU tensor of its logical dtype."""
    arr = np.require(arr, requirements=["C", "W"])
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype.name != dtype_name:
        raise ValueError(f"stored {arr.dtype} for a {dtype_name} leaf")
    return torch.from_numpy(arr)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None,
                    chunk_leaves: int = 64) -> str:
    """Write ``tree`` (params/opt state/... tree) atomically."""
    flat = tree_flatten_with_paths(tree)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {
        "step": step,
        "extra": extra or {},
        "leaves": [],
        "n_files": 0,
    }
    for i in range(0, len(flat), chunk_leaves):
        fname = f"arr_{i // chunk_leaves:05d}.npz"
        payload = {}
        for j, (p, leaf) in enumerate(flat[i:i + chunk_leaves]):
            arr = _to_numpy(leaf)
            payload[f"a{j}"] = arr
            manifest["leaves"].append(
                {"path": p, "file": fname, "key": f"a{j}",
                 "shape": list(arr.shape), "dtype": _dtype_name(leaf)})
        np.savez(os.path.join(tmp, fname), **payload)
        manifest["n_files"] += 1
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)          # atomic publish
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _place(t: torch.Tensor, ref: Any, layout: Any) -> torch.Tensor:
    """The restored full value ``t`` in ``ref``'s dtype, laid out by
    ``layout`` or on ``ref``'s device."""
    if layout is None:
        return t.to(device=ref.device, dtype=ref.dtype)
    from torch.distributed.tensor import distribute_tensor
    mesh = layout.device_mesh
    return distribute_tensor(t.to(device=mesh.device_type, dtype=ref.dtype),
                             mesh, list(layout.placements),
                             src_data_rank=None)


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       target: Any = None, shardings: Any = None):
    """Returns ``(tree, extra)``.  Without ``target``, ``tree`` maps each
    leaf path to a CPU tensor; with it, it has ``target``'s structure, each
    leaf in its target leaf's dtype on its device, or, with ``shardings``
    (a tree of ``target``'s structure whose leaves have ``device_mesh`` and
    ``placements``), laid out by its leaf there: a DTensor of which each
    rank keeps its slice of the full value."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    values: Dict[str, torch.Tensor] = {}
    by_file: Dict[str, Any] = {}
    try:
        for leaf in manifest["leaves"]:
            if leaf["file"] not in by_file:
                by_file[leaf["file"]] = np.load(os.path.join(d, leaf["file"]))
            values[leaf["path"]] = _decode(by_file[leaf["file"]][leaf["key"]],
                                           leaf["dtype"])
    finally:
        for npz in by_file.values():
            npz.close()

    if target is None:
        return values, manifest["extra"]

    flat = tree_flatten_with_paths(target)
    lays = ([leaf for _, leaf in tree_flatten_with_paths(shardings)]
            if shardings is not None else [None] * len(flat))
    out = []
    for (p, ref), layout in zip(flat, lays):
        if p not in values:
            raise KeyError(f"checkpoint missing leaf {p}")
        t = values[p]
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {p}: {tuple(t.shape)} vs "
                             f"{tuple(ref.shape)}")
        out.append(_place(t, ref, layout))
    return tree_unflatten(target, out), manifest["extra"]


def _snapshot(leaf: Any) -> Any:
    """A host copy of a leaf (the full value of a DTensor): the caller may
    change it after a save."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, persist on a background thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.saved_steps: list = []

    def wait(self) -> None:
        """Until the save in flight is written; in a world, every rank
        then meets the others."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()                                  # one in flight at a time
        host_tree = tree_map(_snapshot, tree)        # a collective in a world
        if not _rank0():
            return

        def work():
            save_checkpoint(self.directory, step, host_tree, extra)
            self.saved_steps.append(step)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = sorted(s for d in os.listdir(self.directory)
                       if (m := re.fullmatch(r"step_(\d+)", d))
                       for s in [int(m.group(1))])
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)


class CheckpointManager:
    """Save-every-N policy + resume helper used by ``launch/train.py``."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.every = every
        self.ckpt = AsyncCheckpointer(directory, keep)
        self.async_save = async_save
        self.directory = directory

    def maybe_save(self, step: int, tree: Any, extra=None) -> bool:
        if step % self.every != 0:
            return False
        if self.async_save:
            self.ckpt.save(step, tree, extra)
        else:
            host_tree = tree_map(_snapshot, tree)
            if _rank0():
                save_checkpoint(self.directory, step, host_tree, extra)
            _barrier()
        return True

    def restore_latest(self, target: Any, shardings: Any = None):
        self.ckpt.wait()
        return restore_checkpoint(self.directory, None, target, shardings)

    def finish(self) -> None:
        self.ckpt.wait()
