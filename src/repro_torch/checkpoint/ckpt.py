"""Checkpoint and restore for fault tolerance, in the reference's on-disk
layout.

Port of the reference's ``checkpoint/ckpt.py``; a checkpoint either package
writes restores in the other, bit for bit:

  * ``<dir>/step_XXXXXXXX/shard_{i}.bin``: the raw bytes of every array of
    shard i, in the sorted order of their names;
  * ``index_{i}.json``: per array its dtype (numpy's name; ``bfloat16`` for
    bfloat16), shape, offset and byte count; arrays are named as
    ``jax.tree_util.keystr`` names tree paths (``repro_torch.tree``);
  * ``COMMITTED_{i}``: written last. Shards are written to ``<final>.tmp{i}``
    and moved into place, so a crash never leaves a half-written shard that
    counts as complete.

Partition-aware: each data rank writes its own shard (``shard_id`` = its
rank on the "data" axis, ``num_shards`` = that axis's size), so writes
scale out with the ranks. On a "model" axis above 1 (``mesh`` and the
tree's ``specs`` given) a save gathers every leaf over "model" and the
axis's rank 0 writes it, so a checkpoint holds whole leaves, as the
reference's and a one-process run's do; a restore slices each leaf to this
rank's shard. ``axes=("model", "data")`` does the same over "data" too: an
fsdp state (params stored as "data" shards) and its optimizer slices are
gathered whole and written once (shard 0, by the ranks that are 0 on both
axes), and a restore slices them back. (Writing owned slices instead is
queued: ROADMAP.md.) ``CheckpointManager.save_async`` copies to host
memory before returning (the train step updates its tensors in place),
then writes in a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.sharded import gather_tree, mesh_axis_size, shard_tree
from repro_torch.tree import named_leaves, tree_map, tree_unflatten


def _host(leaf) -> Any:
    """A host copy of a leaf (a tensor's own storage, never shared)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _to_bytes(leaf) -> tuple:
    """(dtype name, shape, bytes) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", list(t.shape), t.view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return str(arr.dtype), list(arr.shape), arr.tobytes()


def _from_bytes(blob: bytes, meta: dict) -> torch.Tensor:
    shape = meta["shape"]
    count = int(np.prod(shape)) if shape else 1
    if meta["dtype"] == "bfloat16":
        arr = np.frombuffer(blob, dtype=np.int16, count=count, offset=meta["offset"])
        return torch.from_numpy(arr.reshape(shape).copy()).view(torch.bfloat16)
    arr = np.frombuffer(blob, dtype=np.dtype(meta["dtype"]), count=count, offset=meta["offset"])
    return torch.from_numpy(arr.reshape(shape).copy())


def _split(mesh, axes) -> bool:
    """Whether any of ``axes`` has more than one rank on ``mesh``."""
    return mesh is not None and any(a in mesh.mesh_dim_names and mesh_axis_size(mesh, a) > 1
                                    for a in axes)


def save_checkpoint(directory: str, tree: Any, step: int, shard_id: int = 0,
                    num_shards: int = 1, mesh=None, specs=None, axes=("model",)) -> str:
    """Write one shard of a checkpoint. Returns the final directory path.
    With ``mesh`` (one of ``axes`` above 1) and ``specs`` (the tree's), the
    leaves are gathered over ``axes`` (every rank of them calls this) and
    only their rank 0 writes."""
    final = os.path.join(directory, f"step_{step:08d}")
    if _split(mesh, axes):
        tree = gather_tree(tree, specs, mesh, axes)
        if any(a in mesh.mesh_dim_names and mesh.get_local_rank(a) != 0 for a in axes):
            return final
    tmp = final + f".tmp{shard_id}"
    os.makedirs(tmp, exist_ok=True)
    index: Dict[str, Any] = {"step": step, "num_shards": num_shards, "arrays": {}}
    with open(os.path.join(tmp, f"shard_{shard_id}.bin"), "wb") as f:
        off = 0
        for name, leaf in sorted(named_leaves(tree), key=lambda kv: kv[0]):
            dtype, shape, data = _to_bytes(leaf)
            index["arrays"][name] = {"dtype": dtype, "shape": shape, "offset": off,
                                     "nbytes": len(data)}
            f.write(data)
            off += len(data)
    with open(os.path.join(tmp, f"index_{shard_id}.json"), "w") as f:
        json.dump(index, f)
    # atomic publish: the first shard creates the final dir; others move in
    os.makedirs(final, exist_ok=True)
    for fname in os.listdir(tmp):
        os.replace(os.path.join(tmp, fname), os.path.join(final, fname))
    shutil.rmtree(tmp, ignore_errors=True)
    with open(os.path.join(final, f"COMMITTED_{shard_id}"), "w") as f:
        f.write("ok")
    return final


def _is_complete(path: str, num_shards: int) -> bool:
    return all(os.path.exists(os.path.join(path, f"COMMITTED_{s}")) for s in range(num_shards))


def latest_step(directory: str, num_shards: int = 1) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                s = int(name.split("_")[1].split(".")[0])
            except ValueError:
                continue
            if _is_complete(os.path.join(directory, name), num_shards):
                steps.append(s)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None,
                       shard_id: int = 0, num_shards: int = 1, mesh=None,
                       specs=None, axes=("model",)) -> "tuple[Any, int]":
    """Restore (a shard of) the tree. ``like`` gives the structure; each leaf
    becomes the stored array as a tensor of the stored dtype, on the like
    leaf's device if that is a tensor (else the CPU). Shapes are checked.
    With ``mesh`` (one of ``axes`` above 1) and ``specs``, ``like`` holds
    this rank's shards over ``axes``: each stored whole leaf is sliced to
    it."""
    if _split(mesh, axes):
        whole = map_like(like, specs, mesh, axes)
        tree, step = restore_checkpoint(directory, whole, step, shard_id, num_shards)
        return tree_map(lambda t: t.contiguous(), shard_tree(tree, specs, mesh, axes)), step
    if step is None:
        step = latest_step(directory, num_shards)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {directory}")
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, f"index_{shard_id}.json")) as f:
        index = json.load(f)
    with open(os.path.join(final, f"shard_{shard_id}.bin"), "rb") as f:
        blob = f.read()
    leaves = []
    for name, leaf in named_leaves(like):
        if name not in index["arrays"]:
            raise KeyError(f"checkpoint missing array {name}")
        stored = _from_bytes(blob, index["arrays"][name])
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else None
        if want is not None and tuple(stored.shape) != want:
            raise ValueError(f"{name}: checkpoint shape {tuple(stored.shape)} != expected {want}")
        if isinstance(leaf, (torch.Tensor, _Like)):
            stored = stored.to(leaf.device)
        leaves.append(stored)
    tree = tree_unflatten(like, leaves)
    return tree, step


def map_like(like, specs, mesh, axes=("model",)):
    """Meta tensors of the whole leaves of a tree of shards over ``axes``
    (the shapes a restore checks), on each leaf's device."""
    from repro_torch.core.sharded import global_shape, map_specs

    return map_specs(lambda t, sp: _Like(global_shape(t.shape, sp, mesh, axes), t.device),
                     like, specs)


class _Like:
    """A leaf of ``like``: its shape and the device to restore onto."""

    def __init__(self, shape, device):
        self.shape, self.device = tuple(shape), device


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async save."""

    def __init__(self, directory: str, keep: int = 3, num_shards: int = 1):
        self.directory = directory
        self.keep = keep
        self.num_shards = num_shards
        self._thread: Optional[threading.Thread] = None

    def save(self, tree, step: int, shard_id: int = 0) -> None:
        save_checkpoint(self.directory, tree_map(_host, tree), step, shard_id, self.num_shards)
        self._gc()

    def save_async(self, tree, step: int, shard_id: int = 0) -> None:
        host_tree = tree_map(_host, tree)  # copied BEFORE returning
        self.wait()

        def write():
            save_checkpoint(self.directory, host_tree, step, shard_id, self.num_shards)
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like, shard_id: int = 0):
        return restore_checkpoint(self.directory, like, None, shard_id, self.num_shards)

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and "." not in n
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
