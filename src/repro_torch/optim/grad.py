"""Gradient utilities (counterpart of ``repro.optim.grad``): micro-batch
accumulation and bf16 compression with error feedback.

``accumulate_grads`` gives the reference's ``0 + g1 + g2 + ...`` and then
``x 1/n`` (``grad.py:36-46``), but accumulates into each parameter's
``.grad`` in place, as autograd's backward does, instead of into a
separate float32 tree (12.85 GB at llama3.2-3b's widths). The
parameters must be float32 leaves that require a gradient.

Under a mesh each gradient reaches ``.grad`` in its parameter's placement:
a hook redistributes it as it arrives (a reduce-scatter of DTensor's
``Partial`` sums), as the reference's SPMD program reduces each
micro-batch's gradients into the parameters' sharding. Accumulating the
``Partial`` sums themselves held a full-size float32 copy of every
gradient on every rank until the update (the dry run's deepseek-67b
train_4k cell: 545.7 GiB a device).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.optim.adamw import tree_leaves, tree_map

__all__ = ["accumulate_grads", "compress_bf16", "decompress_bf16"]

Params = Any


def accumulate_grads(
    loss_fn: Callable[[Params, dict], torch.Tensor],
    params: Params,
    micro_batches: list[dict[str, torch.Tensor]],
) -> tuple[torch.Tensor, Params]:
    """Mean loss and the gradient tree over ``micro_batches``, each run
    forward and backward in turn; the gradients are the parameters'
    ``.grad`` tensors (replaced, not added to)."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.grad = None
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    hooks = [t.register_hook(_placed_like(t)) for t in leaves if isinstance(t, DTensor)]
    try:
        for mb in micro_batches:
            loss = loss_fn(params, mb)
            loss.backward()
            total = total + loss.detach()
    finally:
        for h in hooks:
            h.remove()
    inv = 1.0 / len(micro_batches)
    with torch.no_grad():
        for t in leaves:
            if t.grad is None:  # a leaf no loss reached: the reference's zeros
                t.grad = torch.zeros_like(t, dtype=torch.float32)
            t.grad.mul_(inv)
    return total * inv, tree_map(lambda t: t.grad, params)


def _placed_like(t: DTensor) -> Callable:
    """A gradient hook: the gradient redistributed to ``t``'s placement."""
    mesh, placements = t.device_mesh, tuple(t.placements)

    def hook(g):
        if isinstance(g, DTensor) and tuple(g.placements) != placements:
            return g.redistribute(mesh, placements)
        return g

    return hook


def compress_bf16(grads: Params, residual: Params | None = None) -> tuple[Params, Params]:
    """bf16 compression with error feedback. Returns (compressed, new_residual)."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                            grads)
    kept = []  # each leaf's new residual, in tree_map's order

    def comp(g, r):
        corrected = g.to(torch.float32) + r
        c = corrected.to(torch.bfloat16)
        kept.append(corrected - c.to(torch.float32))
        return c

    compressed = tree_map(comp, grads, residual)
    it = iter(kept)
    return compressed, tree_map(lambda _: next(it), grads)


def decompress_bf16(grads: Params) -> Params:
    return tree_map(lambda g: g.to(torch.float32), grads)
