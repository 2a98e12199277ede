"""Checkpointing (counterpart of ``repro.checkpoint.ckpt``): atomic,
shard-per-host npz snapshots with step management.

Layout (the JAX package's):
  <dir>/step_<N>/meta.json             — treedef + paths + step
  <dir>/step_<N>/shard_<H>.npz         — flat leaves owned by host H
  <dir>/LATEST                         — committed step pointer (atomic rename)

The tree is flattened in the JAX package's leaf order: the fields of a
:class:`~repro_torch.runtime.steps.TrainState` in order, dict keys
sorted, tuples in order, ``None`` holding no leaf; ``meta.json`` holds
the same ``paths`` strings. So a checkpoint written by either package
restores in the other: only the ``treedef`` string differs (the JAX
package's is its ``PyTreeDef``, this one a plain description). Leaves are
written as numpy arrays: tensors are copied to the host, and a bfloat16
tensor is written as float32 (numpy has no bfloat16 of its own), which
holds its values exactly; ``restore`` gives each leaf the type and device
of the matching leaf of ``tree_like``.

Under a mesh a DTensor leaf is written whole (``full_tensor()``, a
collective: every rank of its mesh takes part), as ``np.asarray`` of a
sharded JAX array gathers it, so the files do not depend on the mesh;
``restore`` places each leaf as the matching DTensor of ``tree_like`` is
placed.

Fault-tolerance contract: a checkpoint is visible only after its LATEST
pointer is renamed into place, so a crash mid-write never corrupts
restart state.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

__all__ = ["save", "restore", "latest_step", "flatten_with_paths", "unflatten"]


def _children(tree: Any) -> list[tuple[str, Any]] | None:
    """(path step, child) pairs of a node in the JAX package's order, or
    None for a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        # A registered pytree node of the JAX package: its fields by index.
        return [(f"[<flat index {i}>]", getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree))]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def flatten_with_paths(tree: Any) -> list[tuple[str, Any]]:
    """(path, leaf) pairs in the JAX package's order and path spelling
    (``jax.tree_util.keystr``); ``None`` holds no leaf."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("", tree)]
    return [(key + path, leaf) for key, child in kids
            for path, leaf in flatten_with_paths(child)]


def unflatten(like: Any, leaves) -> Any:
    """A tree shaped like ``like`` whose leaves are drawn from the iterator
    ``leaves`` in :func:`flatten_with_paths`' order."""
    if like is None:
        return None
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: unflatten(getattr(like, f.name), leaves) for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        got = {k: unflatten(like[k], leaves) for k in sorted(like)}
        return {k: got[k] for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _treedef(tree: Any) -> str:
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return f"{type(tree).__name__}({', '.join(f.name for f in dataclasses.fields(tree))})"
    return type(tree).__name__


def save(directory: str, step: int, tree: Any, host_id: int = 0, n_hosts: int = 1) -> str:
    """Write a checkpoint snapshot. Returns the committed step dir."""
    os.makedirs(directory, exist_ok=True)
    step_dir = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(step_dir, exist_ok=True)

    items = flatten_with_paths(tree)
    # Host H owns leaves with index % n_hosts == H (layout-agnostic striping).
    owned = {
        f"leaf_{i:05d}": _to_numpy(leaf)
        for i, (_, leaf) in enumerate(items)
        if i % n_hosts == host_id
    }
    tmp = tempfile.NamedTemporaryFile(dir=step_dir, suffix=".tmp", delete=False)
    np.savez(tmp, **owned)
    tmp.close()
    os.replace(tmp.name, os.path.join(step_dir, f"shard_{host_id:04d}.npz"))

    if host_id == 0:
        meta = {
            "step": step,
            "n_hosts": n_hosts,
            "n_leaves": len(items),
            "paths": [p for p, _ in items],
            "treedef": _treedef(tree),
        }
        with open(os.path.join(step_dir, "meta.json"), "w") as f:
            json.dump(meta, f)
        # Atomic commit.
        tmp_ptr = os.path.join(directory, ".LATEST.tmp")
        with open(tmp_ptr, "w") as f:
            f.write(str(step))
        os.replace(tmp_ptr, os.path.join(directory, "LATEST"))
    return step_dir


def latest_step(directory: str) -> int | None:
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            return int(f.read().strip())
    except FileNotFoundError:
        return None


def restore(directory: str, tree_like: Any, step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like``: a tensor leaf comes back
    as a tensor of that leaf's type and device, any other leaf as a numpy
    array of the stored type, each reshaped to the leaf's shape.

    Works across host counts: reads every shard file present.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    step_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(step_dir, "meta.json")) as f:
        meta = json.load(f)
    leaves: dict[int, np.ndarray] = {}
    for fn in sorted(os.listdir(step_dir)):
        if fn.startswith("shard_") and fn.endswith(".npz"):
            with np.load(os.path.join(step_dir, fn)) as z:
                for key in z.files:
                    leaves[int(key.split("_")[1])] = z[key]
    if len(leaves) != meta["n_leaves"]:
        raise IOError(f"checkpoint incomplete: {len(leaves)}/{meta['n_leaves']} leaves")
    flat = [leaf for _, leaf in flatten_with_paths(tree_like)]
    if len(flat) != meta["n_leaves"]:
        raise ValueError("tree structure mismatch vs checkpoint")

    def leaf(i: int, ref: Any):
        a = np.asarray(leaves[i]).reshape(tuple(np.shape(ref)))
        if isinstance(ref, torch.Tensor):
            t = torch.from_numpy(np.array(a)).to(device=ref.device, dtype=ref.dtype)
            if isinstance(ref, DTensor):  # every rank read the whole leaf
                mesh = ref.device_mesh
                t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
                t = t.redistribute(mesh, ref.placements)
            return t
        return a

    restored = [leaf(i, ref) for i, ref in enumerate(flat)]
    return unflatten(tree_like, iter(restored)), step
