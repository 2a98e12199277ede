"""Sharding policy (counterpart of ``repro.distribution.sharding``):
parameter, optimizer, cache and batch shardings, and the activation rules.

Strategy (the JAX package's, on its production mesh):
  * Batch (DP): over ('pod', 'data') — multi-pod data parallelism.
  * FSDP: parameter/optimizer rows sharded over 'data' (within-pod only).
  * TP: attention heads / FFN inner / experts (EP) over 'model'.

Every rule degrades gracefully: an axis is dropped from a spec whenever
the dimension is not divisible by the axis extent. The rules, their
regexes and their order are the JAX package's, and the paths they match
are spelled as ``jax.tree_util.keystr`` spells them
(:func:`repro_torch.checkpoint.ckpt.flatten_with_paths`), so both packages
give every leaf the same :class:`PartitionSpec`.

A spec becomes DTensor placements in :attr:`NamedSharding.placements`: a
tensor dim ``d`` named by mesh axis ``a`` is ``Shard(d)`` on mesh dim
``a``; a tuple ``("pod", "data")`` on dim ``d`` is ``Shard(d)`` on both
mesh dims, the outer one first, as JAX nests a tuple major to minor; every
other mesh dim is ``Replicate()``. :func:`distribute` places a tree of
tensors that every rank holds in full, :func:`gather` brings a tree of
DTensors back to full tensors.
"""

from __future__ import annotations

import os
import re
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.checkpoint.ckpt import flatten_with_paths, unflatten

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "batch_axes",
    "fit_spec",
    "param_sharding",
    "state_sharding",
    "cache_sharding",
    "batch_sharding",
    "activation_rules",
    "placements",
    "shard_index",
    "distribute",
    "gather",
]


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or
    ``None``; missing trailing entries are ``None``. A tuple of one name is
    that name, as ``jax.sharding.PartitionSpec`` spells it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _mesh_shape(mesh) -> Mapping:
    """Axis name -> extent: a JAX-style ``mesh.shape`` mapping, or a
    ``DeviceMesh``'s dim names and sizes."""
    if isinstance(mesh.shape, Mapping):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (one per mesh dim)."""
    names = _axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{axis} is not in the mesh's dim order {names}")
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


def shard_index(mesh, pl: tuple, dim: int) -> int:
    """This rank's index among the shards of tensor dim ``dim`` under the
    placements ``pl``, the outer mesh dim first (0 where ``dim`` is not
    split)."""
    i = 0
    for m, p in enumerate(pl):
        if p.is_shard(dim):
            i = i * mesh.size(m) + mesh.get_local_rank(m)
    return i


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s two fields). A
    leaf of the trees below, so neither a dataclass nor a tuple."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and self.mesh is other.mesh
                and self.spec == other.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in _axis_names(mesh) else ("data",)


def _axis_size(mesh, axis) -> int | None:
    """Extent of a (possibly tuple) mesh axis; None if absent from mesh."""
    if axis is None:
        return 1
    shape = _mesh_shape(mesh)
    names = axis if isinstance(axis, tuple) else (axis,)
    size = 1
    for a in names:
        if a not in shape:
            return None
        size *= int(shape[a])
    return size


def fit_spec(mesh, shape: tuple[int, ...], spec: PartitionSpec) -> PartitionSpec:
    """Drop axes absent from the mesh or whose extent does not divide the
    dimension."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, parts):
        size = _axis_size(mesh, axis) if axis else None
        out.append(axis if axis and size and dim % size == 0 else None)
    return P(*out)


# (path regex, spec builder) — first match wins. Specs exclude the stacked
# leading repeat axis, which is added automatically for leaves under
# ['layers'] / ['enc'].
_PARAM_RULES: list[tuple[str, PartitionSpec]] = [
    (r"\['embed'\]\['table'\]", P("model", "data")),
    (r"\['out'\]\['table'\]", P("model", "data")),
    # Attention: column-parallel QKV, row-parallel O.
    (r"\['w[qkv]'\]\['w'\]", P("data", "model")),
    (r"\['w[qkv]'\]\['b'\]", P("model")),
    (r"\['wo'\]\['w'\]", P("model", "data")),
    (r"\['wo'\]\['b'\]", P()),
    # Dense MLP (wi/wg are column-parallel; wo matched above).
    (r"\['w[ig]'\]\['w'\]", P("data", "model")),
    # MoE: experts over 'model' (EP), rows FSDP over 'data'.
    (r"\['moe'\]\['router'\]", P("data", None)),
    (r"\['moe'\]\['w[ig]'\]", P("model", "data", None)),
    (r"\['moe'\]\['wo'\]", P("model", None, "data")),
    # SSD / mamba.
    (r"\['w[zx]'\]\['w'\]", P("data", "model")),
    (r"\['wbc'\]", P("data", None)),
    (r"\['wdt'\]", P("data", None)),
    (r"\['conv_w'\]", P(None, "model")),
    (r"\['conv_b'\]", P("model")),
    (r"\['out_proj'\]\['w'\]", P("model", "data")),
    # xLSTM blocks.
    (r"\['up'\]\['w'\]", P("data", "model")),
    (r"\['down'\]\['w'\]", P("model", "data")),
    (r"\['wif'\]\['w'\]", P("data", None)),
    (r"\['wx'\]\['w'\]", P("data", "model")),
    (r"\['wh'\]\['w'\]", P("data", "model")),
    # Norm scales and leftovers: replicate.
    (r".*", P()),
]


def _spec_for_path(path: str, shape: tuple[int, ...]) -> PartitionSpec:
    stacked = "['layers']" in path or "['enc']" in path
    core_shape = shape[1:] if stacked else shape
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            chosen = spec
            break
    if stacked:
        chosen = P(*((None,) + tuple(chosen) + (None,) * max(0, len(core_shape) - len(chosen))))
    return chosen


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _map_paths(tree: Any, fn) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree`` (the JAX package's
    paths and order), in ``tree``'s structure."""
    return unflatten(tree, iter([fn(p, leaf) for p, leaf in flatten_with_paths(tree)]))


def param_sharding(params_shapes: Any, mesh) -> Any:
    """NamedSharding tree for a params (or grads/opt-moment) shape tree."""
    def one(path, leaf):
        shape = _shape(leaf)
        return NamedSharding(mesh, fit_spec(mesh, shape, _spec_for_path(path, shape)))

    return _map_paths(params_shapes, one)


def state_sharding(state_shapes: Any, mesh) -> Any:
    """TrainState sharding: m/v mirror params; scalars replicate."""
    def one(path, leaf):
        shape = _shape(leaf)
        if len(shape) == 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, fit_spec(mesh, shape, _spec_for_path(path, shape)))

    return _map_paths(state_shapes, one)


def cache_sharding(cache_shapes: Any, mesh) -> Any:
    """Decode-cache sharding.

    Attention KV [R, B, T, KV, D]: batch over DP axes when divisible,
    otherwise the TIME axis shards over 'data' (long-context, batch=1);
    D over 'model' when divisible. States shard batch + heads.
    """
    dp = batch_axes(mesh)

    def leaf_spec(path: str, shape: tuple[int, ...]) -> PartitionSpec:
        nd = len(shape)
        if nd == 0:
            return P()
        if re.search(r"\['memory'\]", path):
            return fit_spec(mesh, shape, P(dp, None, None))
        if re.search(r"\['[kv]'\]$", path) and nd == 5:
            R, B, T, KV, D = shape
            if B % _axis_size(mesh, dp) == 0:
                return fit_spec(mesh, shape, P(None, dp, None, None, "model"))
            return fit_spec(mesh, shape, P(None, None, "data", None, "model"))
        if re.search(r"\['ssm'\]", path) and nd == 5:
            return fit_spec(mesh, shape, P(None, dp, "model", None, None))
        if re.search(r"\['conv'\]", path) and nd == 4:
            return fit_spec(mesh, shape, P(None, dp, None, "model"))
        if re.search(r"\['C'\]", path) and nd == 4:
            return fit_spec(mesh, shape, P(None, dp, "model", None))
        # Generic states: shard batch dim (axis 1 after stacking) if possible.
        spec = [None] * nd
        if nd >= 2:
            spec[1] = dp
        return fit_spec(mesh, shape, P(*spec))

    return _map_paths(cache_shapes, lambda p, leaf: NamedSharding(mesh, leaf_spec(p, _shape(leaf))))


def batch_sharding(batch_shapes: Any, mesh) -> Any:
    dp = batch_axes(mesh)

    def spec(_path, leaf) -> NamedSharding:
        shape = _shape(leaf)
        s = [None] * len(shape)
        if len(shape) >= 1:
            s[0] = dp
        return NamedSharding(mesh, fit_spec(mesh, shape, P(*s)))

    return _map_paths(batch_shapes, spec)


def activation_rules(mesh) -> dict[str, NamedSharding]:
    """Logical-activation constraints consumed by models.layers.shard()."""
    dp = batch_axes(mesh)
    mk = lambda *spec: NamedSharding(mesh, P(*spec))  # noqa: E731
    # Activation residency mode (the JAX package's §Perf iterations):
    #   dshard     — hidden d-sharded everywhere (min HBM footprint/traffic;
    #                consumers re-gather per use)
    #   replicated — hidden replicated over 'model' (min collectives; remat
    #                carry is full-size)
    #   boundary   — d-sharded carry, un-sharded once per period
    mode = os.environ.get("REPRO_ACT_MODE", "dshard")
    full = mk(dp, None, None)
    dsh = mk(dp, None, "model")
    if mode == "replicated":
        act = {"act_in": full, "act_mid": full, "act_out": full}
    elif mode == "boundary":
        act = {"act_in": full, "act_mid": full, "act_out": dsh}
    else:
        act = {"act_in": dsh, "act_mid": dsh, "act_out": dsh}
    return {
        **act,
        "act_hidden": act["act_out"],
        "act_logits": mk(dp, None, "model"),
        "act_ffn": mk(dp, None, "model"),
        "act_heads": mk(dp, None, "model", None),
        "act_lse": mk(dp, None, "model"),
        # Experts over 'model' (EP); capacity deliberately unsharded, as in
        # the JAX package.
        "act_expert": mk("model", None, None),
        "act_expert_ffn": mk("model", None, None),
    }


def _place(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``t``, held in full by every rank, as a DTensor: each rank keeps its
    own shard (no communication). A DTensor is redistributed."""
    mesh = sharding.mesh
    if isinstance(t, DTensor):
        return t.redistribute(mesh, sharding.placements)
    full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return full.redistribute(mesh, sharding.placements)


def distribute(tree: Any, shardings: Any) -> Any:
    """A tree of tensors that every rank holds in full, placed leaf by leaf
    by the matching tree of :class:`NamedSharding`; a leaf that is no
    tensor (a Python int, a CPU step counter) stays as it is."""
    shards = [s for _, s in flatten_with_paths(shardings)]
    it = iter(shards)

    def one(_path, leaf):
        sh = next(it)
        if not isinstance(leaf, torch.Tensor) or (leaf.dim() == 0 and leaf.device.type == "cpu"):
            return leaf
        return _place(leaf, sh)

    return _map_paths(tree, one)


def gather(tree: Any) -> Any:
    """Full tensors of a tree's DTensor leaves (other leaves unchanged)."""
    return _map_paths(
        tree, lambda _p, leaf: leaf.full_tensor() if isinstance(leaf, DTensor) else leaf)
