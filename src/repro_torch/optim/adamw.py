"""AdamW from scratch (counterpart of ``repro.optim.adamw``): decoupled
weight decay, global-norm clipping, cosine schedule with linear warmup.
State is a tree mirroring the parameters.

The operations and their order are the JAX package's
(``adamw.py:59-96``). Two things differ, neither in value:

  * The update is in place: ``adamw_update`` writes the new parameters, m
    and v into the tensors it is given (under ``torch.no_grad()``) and
    returns the same objects. A functional update would hold a second copy
    of the parameters and both moments.
  * A leaf of more than ``SLICE_ELEMENTS`` elements is updated in slices
    along its leading axes (the repeats of a stacked layer leaf, rows of
    an embedding table; the experts of a MoE leaf stacked over one
    repeat), so the float32 temporaries of the formula are a slice's and
    not the leaf's (at llama3.2-3b's widths a stacked MLP leaf is 2.8 GB
    beside 51 GB of state, at jamba's one expert leaf 3.8 GB). The
    operation is elementwise, so the values are the same.

The step count, the learning rate and the bias corrections are float32
scalars computed on the host as the reference computes them in float32;
the clip factor comes from the gradients' norm and stays on the device,
so a step makes no host-device round trip.

Under a mesh the parameters, m and v are DTensors of one placement per
leaf (``distribution.sharding.state_sharding``). Each gradient is first
redistributed to its parameter's placements (it may arrive ``Partial``),
the norm sums each leaf's local squares over the ranks that hold distinct
shards of it, and the elementwise update runs on the local shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.obs.trace import current

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "tree_leaves",
    "tree_map",
    "SLICE_ELEMENTS",
]

Params = Any

# Largest number of elements updated at once (float32: 256 MiB a temporary).
SLICE_ELEMENTS = 1 << 26

# Spans on the current tracer (repro_torch.obs.trace.current).
CLIP = "optim.clip"
ADAMW = "optim.adamw"


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree: Any) -> list:
    """Leaves in the JAX package's flattening order: dict keys sorted,
    tuples and lists in order, ``None`` holding no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` leaf by leaf over trees of one structure (dicts, tuples,
    lists; ``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (an int or integer tensor), a float32
    0-d CPU tensor, computed in float32 as ``adamw.py:32-41``."""
    step = torch.as_tensor(step).detach().to("cpu", torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (1 + torch.cos(_f32(math.pi) * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


# Elements a squared copy holds at most while a norm is summed (float32:
# 256 MiB); fixed, so the sum's order does not follow SLICE_ELEMENTS.
NORM_CHUNK = 1 << 26


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """float32 sum of the squares of ``x``: ``torch.sum`` of the squares
    of each NORM_CHUNK elements in turn, the chunks' sums added in order.
    ``torch.sum`` reduces in a tree on the card and in cascades on the
    CPU, as the reference's ``jnp.sum`` does; ``torch.linalg.vector_norm``
    on the CPU accumulates in sequence, which put the norm of a
    262,144-entry embedding gradient 2.8e-5 relative off the reference's."""
    total = None
    for part in torch.split(x.detach().reshape(-1), NORM_CHUNK):
        sq = torch.sum(torch.square(part.to(torch.float32)))
        total = sq if total is None else total + sq
    return total if total is not None else torch.zeros((), device=x.device)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (``_sum_squares``). With DTensor leaves the result is a plain tensor,
    the same on every rank."""
    leaves = tree_leaves(tree)
    if any(isinstance(x, DTensor) for x in leaves):
        return _global_norm_sharded(leaves)
    return torch.sqrt(torch.sum(torch.stack([_sum_squares(x) for x in leaves])))


def _global_norm_sharded(leaves: list) -> torch.Tensor:
    """:func:`global_norm` of DTensor leaves: each leaf's local sum of
    squares is a partial sum over the mesh dims that shard it and a full
    one over the others. The squares are reduced over the ranks leaf by
    leaf (one collective for each set of sharded dims) and then summed in
    leaf order, as the plain version sums them: on a 1 x 1 mesh the result
    is the plain version's bit for bit."""
    sqs, keys = [], []
    for x in leaves:
        mesh = x.device_mesh
        pl = [Replicate() if p.is_partial() else p for p in x.placements]
        local = x.detach().redistribute(mesh, pl).to_local()
        sqs.append(_sum_squares(local))
        keys.append(tuple(p.is_shard() for p in pl))
    sqs = torch.stack(sqs)
    for key in set(keys):
        if not any(key):
            continue  # replicated: every rank holds the whole sum
        idx = torch.tensor([i for i, k in enumerate(keys) if k == key], device=sqs.device)
        part = [Partial() if s else Replicate() for s in key]
        full = DTensor.from_local(sqs[idx], mesh, part, run_check=False).full_tensor()
        sqs = sqs.index_copy(0, idx, full)
    return torch.sqrt(torch.sum(sqs))


def adamw_init(params: Params) -> dict[str, Any]:
    """Zero float32 moments shaped like ``params`` and step 0 (an int32
    0-d CPU tensor: the host reads it to make the schedule)."""
    def zeros(p):
        return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device), p)

    return {"m": zeros(params), "v": zeros(params), "step": torch.zeros((), dtype=torch.int32)}


def _slices(t: torch.Tensor) -> list:
    """Views of ``t`` of at most SLICE_ELEMENTS elements each, taken along
    its leading axis, and along the next one within a leading row that is
    larger than that (one view, ``t`` itself, for a small leaf)."""
    if t.numel() <= SLICE_ELEMENTS or t.dim() == 0:
        return [t]
    per_row = t.numel() // t.shape[0]
    if per_row > SLICE_ELEMENTS:
        return [s for row in torch.unbind(t, dim=0) for s in _slices(row)]
    return list(torch.split(t, SLICE_ELEMENTS // per_row, dim=0))


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: Params,
    grads: Params,
    state: dict[str, Any],
) -> tuple[Params, dict[str, Any], dict[str, torch.Tensor]]:
    """One AdamW step, in place. Returns (params, state, metrics) with the
    same parameter and moment tensors updated; metrics are ``grad_norm``
    (a 0-d device tensor) and ``lr`` (a float32 0-d CPU tensor)."""
    tr = current()
    step = state["step"] + 1
    p_leaves = tree_leaves(params)
    g_leaves = [g.redistribute(p.device_mesh, p.placements) if isinstance(g, DTensor) else g
                for p, g in zip(p_leaves, tree_leaves(grads))]
    with tr.span(CLIP):
        gnorm = global_norm(g_leaves)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = cosine_schedule(cfg, step)
    b1t = float(1.0 - torch.pow(_f32(cfg.b1), step.to(torch.float32)))
    b2t = float(1.0 - torch.pow(_f32(cfg.b2), step.to(torch.float32)))
    lr_f = float(lr)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mh = m / b1t
        vh = v / b2t
        pf = p.to(torch.float32)
        p.copy_(pf - lr_f * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf))

    leaves = zip(p_leaves, g_leaves, tree_leaves(state["m"]), tree_leaves(state["v"]))
    with tr.span(ADAMW):
        for leaf in leaves:
            p, g, m, v = (t.to_local() if isinstance(t, DTensor) else t for t in leaf)
            for part in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
                upd(*part)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
