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
    along its leading axis (the repeats of a stacked layer leaf, rows of
    an embedding table), so the float32 temporaries of the formula are a
    slice's and not the leaf's (at llama3.2-3b's widths a stacked MLP
    leaf is 2.8 GB beside 51 GB of state). The operation is elementwise,
    so the values are the same.

The step count, the learning rate and the bias corrections are float32
scalars computed on the host as the reference computes them in float32;
the clip factor comes from the gradients' norm and stays on the device,
so a step makes no host-device round trip.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

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


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (taken without a squared copy of the leaf)."""
    leaves = [
        torch.square(torch.linalg.vector_norm(x.detach(), dtype=torch.float32))
        for x in tree_leaves(tree)
    ]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_init(params: Params) -> dict[str, Any]:
    """Zero float32 moments shaped like ``params`` and step 0 (an int32
    0-d CPU tensor: the host reads it to make the schedule)."""
    def zeros(p):
        return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device), p)

    return {"m": zeros(params), "v": zeros(params), "step": torch.zeros((), dtype=torch.int32)}


def _slices(t: torch.Tensor) -> list:
    """Views of ``t`` along its leading axis of at most SLICE_ELEMENTS
    elements each (one view, ``t`` itself, for a small leaf)."""
    if t.numel() <= SLICE_ELEMENTS or t.dim() == 0:
        return [t]
    rows = max(1, SLICE_ELEMENTS // (t.numel() // t.shape[0]))
    return list(torch.split(t, rows, dim=0))


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
    step = state["step"] + 1
    gnorm = global_norm(grads)
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

    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                 tree_leaves(state["v"]))
    for p, g, m, v in leaves:
        for part in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
            upd(*part)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
