"""State carried across from the JAX package.

The scheduler has no weights: its state is the problem instance (the
:class:`DagJob`, the resource environment and the optional
:class:`Topology`) plus warm-start seed pools, which are plain integer
arrays already. ``instance_to_arrays`` / ``instance_from_arrays`` move an
instance through a dict of plain numpy arrays and scalars, so that an
instance of either package can be rebuilt in the other without one
importing the other.

The language models' state is their parameter tree and KV cache: nested
dicts and tuples of arrays with the same structure in both packages.
``lm_params_from_arrays`` / ``lm_cache_from_arrays`` take the JAX
package's trees as numpy arrays (``jax.tree.map(np.asarray, tree)`` on
the caller's side) and return the port's, leaf by leaf;
``lm_tree_to_arrays`` goes back. bfloat16 leaves (numpy arrays of the
``bfloat16`` extension dtype) cross bit for bit.

A training state crosses the same way: ``train_state_from_arrays`` takes
the JAX package's ``TrainState`` as numpy arrays (params, the AdamW
``opt`` m / v / step, the error-feedback residual or ``None``) and
returns the port's :class:`~repro_torch.runtime.steps.TrainState`;
``train_state_to_arrays`` gives back a dict of its three fields, from
which the caller builds the JAX package's ``TrainState(**d)``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dag import DagJob
from repro_torch.core.instance import ProblemInstance, Topology
from repro_torch.device import resolve_device

__all__ = [
    "instance_to_arrays",
    "instance_from_arrays",
    "lm_params_from_arrays",
    "lm_cache_from_arrays",
    "lm_tree_to_arrays",
    "train_state_from_arrays",
    "train_state_to_arrays",
]


def instance_to_arrays(inst) -> dict:
    """Plain-numpy view of a ``ProblemInstance`` of either package: ``p``,
    ``edges``, ``d``, ``name``, ``n_racks``, ``n_wireless``, ``wired_rate``,
    ``wireless_rate``, ``local_delay`` and, when the instance has a
    topology, ``reach``, ``degree``, ``channel_degree`` and ``delta``."""
    job = inst.job
    out = {
        "p": np.array(job.p, dtype=np.float64),
        "edges": np.array(job.edges, dtype=np.int64),
        "d": np.array(job.d, dtype=np.float64),
        "name": str(job.name),
        "n_racks": int(inst.n_racks),
        "n_wireless": int(inst.n_wireless),
        "wired_rate": float(inst.wired_rate),
        "wireless_rate": float(inst.wireless_rate),
        "local_delay": np.array(inst.local_delay, dtype=np.float64),
    }
    topo = inst.topology
    if topo is not None:
        out.update(
            reach=np.array(topo.reach, dtype=bool),
            degree=topo.degree,
            channel_degree=topo.channel_degree,
            delta=float(topo.delta),
        )
    return out


def instance_from_arrays(d: dict) -> ProblemInstance:
    """Rebuild a port ``ProblemInstance`` from :func:`instance_to_arrays`'s
    dict. A 0-d ``local_delay`` becomes the scalar it was."""
    local = np.asarray(d.get("local_delay", 0.0), dtype=np.float64)
    topology = None
    if d.get("reach") is not None:
        topology = Topology(
            reach=np.asarray(d["reach"], dtype=bool),
            degree=None if d.get("degree") is None else int(d["degree"]),
            channel_degree=(
                None if d.get("channel_degree") is None else int(d["channel_degree"])
            ),
            delta=float(d.get("delta", 0.0)),
        )
    return ProblemInstance(
        job=DagJob(
            p=np.asarray(d["p"], dtype=np.float64),
            edges=np.asarray(d["edges"], dtype=np.int64),
            d=np.asarray(d["d"], dtype=np.float64),
            name=str(d.get("name", "job")),
        ),
        n_racks=int(d["n_racks"]),
        n_wireless=int(d.get("n_wireless", 1)),
        wired_rate=float(d.get("wired_rate", 1.0)),
        wireless_rate=float(d.get("wireless_rate", 1.0)),
        local_delay=float(local) if local.ndim == 0 else local,
        topology=topology,
    )


def _leaf_to_tensor(a, device: torch.device, dtype) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # writable: caches update in place
    if a.dtype.name == "bfloat16":  # the bfloat16 extension dtype: same bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return None if tree is None else fn(tree)


def lm_params_from_arrays(tree, device=None, dtype=None):
    """The port's parameter tree from the JAX package's, given as nested
    dicts / tuples of numpy arrays. ``dtype`` casts the floating leaves
    (``None`` keeps each leaf's type); ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    return _map(tree, lambda a: _leaf_to_tensor(a, dev, dtype))


def lm_cache_from_arrays(cache, device=None):
    """The port's decode cache from the JAX package's: ``pos`` (a 0-d
    integer array) becomes a Python int; ``layers`` (a tuple over the
    period positions of {"k", "v"} dicts, SSD {"ssm", "conv"} and mLSTM
    {"C", "n", "m"} states, sLSTM (c, n, m, h) tuples and the empty dicts
    of cross layers) and ``memory`` (None, or the encoded frames or
    patches) keep each leaf's type and their structure."""
    dev = resolve_device(device)
    memory = cache.get("memory")
    return {
        "pos": int(np.asarray(cache["pos"])),
        "layers": _map(tuple(cache["layers"]), lambda a: _leaf_to_tensor(a, dev, None)),
        "memory": None if memory is None else _leaf_to_tensor(memory, dev, None),
    }


def lm_tree_to_arrays(tree):
    """numpy arrays of a port tree (parameters or cache), leaf by leaf;
    bfloat16 leaves come back as float32 (numpy has no bfloat16 of its
    own), which holds their values exactly."""
    def leaf(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return np.asarray(t)

    return _map(tree, leaf)


def _field(state, name: str):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def train_state_from_arrays(state, device=None):
    """The port's ``TrainState`` from the JAX package's, given as numpy
    arrays (``jax.tree.map(np.asarray, state)``, or a dict of the fields
    ``params``, ``opt`` and ``residual``): params, m, v and the residual on
    ``device`` (``None`` = the CUDA card) in their own types, the step an
    int32 0-d CPU tensor, as ``adamw_init`` makes it."""
    from repro_torch.runtime.steps import TrainState

    dev = resolve_device(device)
    opt = _field(state, "opt")
    residual = _field(state, "residual")
    to = lambda a: _leaf_to_tensor(a, dev, None)  # noqa: E731
    return TrainState(
        params=_map(_field(state, "params"), to),
        opt={"m": _map(opt["m"], to), "v": _map(opt["v"], to),
             "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32)},
        residual=None if residual is None else _map(residual, to),
    )


def train_state_to_arrays(state) -> dict:
    """{"params", "opt", "residual"} of a port ``TrainState`` as numpy
    arrays (the step an int32 0-d array), the JAX package's field order."""
    opt = state.opt
    return {
        "params": lm_tree_to_arrays(state.params),
        "opt": {"m": lm_tree_to_arrays(opt["m"]), "v": lm_tree_to_arrays(opt["v"]),
                "step": np.asarray(int(opt["step"]), dtype=np.int32)},
        "residual": None if state.residual is None else lm_tree_to_arrays(state.residual),
    }
