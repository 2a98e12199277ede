"""Step builders (counterpart of ``repro.runtime.steps``): the training
step (grad-accumulated AdamW), the prefill step and the serve step.

PyTorch runs eagerly, so a step is a plain function of its state; there
is nothing to jit. The training step updates its state in place (the
parameters, m and v; see :mod:`repro_torch.optim.adamw`) and returns the
same tensors in a new :class:`TrainState`.

Under a mesh the state's tensors are DTensors placed by
``distribution.sharding.state_sharding`` and the batch's by
``batch_sharding`` (``launch/train.py`` places both); the step is the
same code, with each micro-batch placed again by ``batch_sharding`` and
the loss returned as a plain tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distribution.sharding import batch_sharding, distribute
from repro_torch.models.lm import Model
from repro_torch.obs.trace import current
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_map,
)
from repro_torch.optim.grad import accumulate_grads, compress_bf16

__all__ = [
    "TrainState",
    "make_train_state",
    "build_train_step",
    "build_prefill_step",
    "build_serve_step",
]

Params = Any

# Spans on the current tracer (repro_torch.obs.trace.current).
TRAIN_STEP = "train.step"
PREFILL_STEP = "prefill.step"


@dataclasses.dataclass
class TrainState:
    """Fields in the JAX package's order (its pytree flattening, and so the
    checkpoint's leaf order, follows it)."""

    params: Params
    opt: dict[str, Any]
    residual: Params | None = None  # error-feedback state (compression on)


def make_train_state(model: Model, seed: int, device=None, compress: bool = False) -> TrainState:
    """float32 master weights from ``seed`` (``model.init``), zero AdamW
    moments and, with ``compress``, a zero float32 error-feedback residual;
    ``device=None`` is the CUDA card."""
    params = model.init(seed, device=device)
    residual = (
        tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        if compress
        else None
    )
    return TrainState(params=params, opt=adamw_init(params), residual=residual)


def _micro_batches(batch: dict[str, torch.Tensor], n_micro: int) -> list[dict]:
    """The reference's ``x.reshape((n_micro, B // n_micro) + ...)``: micro
    batch i is rows [i B / n, (i + 1) B / n) of every entry."""
    B = next(iter(batch.values())).shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} micro-batches")
    per = B // n_micro
    meshes = [v.device_mesh for v in batch.values() if isinstance(v, DTensor)]
    if meshes:
        # A micro-batch's rows lie on other ranks than the batch's: gather
        # the batch (token ids, and frames or patches where the model has
        # them) and place each micro-batch by its own batch sharding.
        full = {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in batch.items()}
        mbs = [{k: v[i * per:(i + 1) * per] for k, v in full.items()} for i in range(n_micro)]
        return [distribute(mb, batch_sharding(mb, meshes[0])) for mb in mbs]
    return [{k: v[i * per:(i + 1) * per] for k, v in batch.items()} for i in range(n_micro)]


def build_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    n_micro: int = 1,
    compress_grads: bool = False,
    cast_params_bf16: bool = False,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), metrics being
    ``loss`` and ``grad_norm`` (0-d device tensors) and ``lr`` (a float32
    0-d CPU tensor).

    ``n_micro`` splits the batch into micro-batches run forward and
    backward in turn, their gradients summed into each parameter's
    ``.grad`` and scaled by 1 / n_micro (the reference's ``lax.scan``
    accumulation, ``steps.py:73-82``). With ``compress_grads`` the summed
    gradient is bf16-compressed with float32 error feedback. With
    ``cast_params_bf16`` the parameters are cast to bf16 at the loss's
    entry (float32 masters stay in the optimizer). The gradients are freed
    after the update.
    """

    def loss_fn(params: Params, mb: dict[str, torch.Tensor]) -> torch.Tensor:
        if cast_params_bf16:
            params = tree_map(
                lambda x: x.to(torch.bfloat16) if x.dtype == torch.float32 else x, params
            )
        return model.loss(params, mb)

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        with current().span(TRAIN_STEP):
            leaves = tree_leaves(state.params)
            for t in leaves:
                t.requires_grad_(True)
            loss, grads = accumulate_grads(loss_fn, state.params, _micro_batches(batch, n_micro))
            residual = state.residual
            if compress_grads:
                grads, residual = compress_bf16(grads, residual)
                grads = tree_map(lambda g: g.to(torch.float32), grads)
            params, opt, metrics = adamw_update(opt_cfg, state.params, grads, state.opt)
            for t in leaves:
                t.grad = None
            if isinstance(loss, DTensor):
                loss = loss.full_tensor()
        return TrainState(params=params, opt=opt, residual=residual), dict(metrics, loss=loss)

    return train_step


def build_prefill_step(model: Model) -> Callable:
    """prefill_step(params, batch) -> last-position logits [B, 1, V];
    ``batch["memory"]``, where given, is the raw frames or patches."""

    @torch.no_grad()
    def prefill_step(params: Params, batch: dict[str, torch.Tensor]):
        with current().span(PREFILL_STEP):
            return model.prefill(params, batch["tokens"], memory=batch.get("memory"))

    return prefill_step


def build_serve_step(model: Model) -> Callable:
    """serve_step(params, cache, token) -> (logits, cache): one decode step.

    The JAX package's ``serve_bf16`` flag (``steps.py:120-126``) casts
    fp32 parameters to bf16 at every step. The port holds the serving
    weights in bf16 from load time instead (``model.init(seed,
    dtype=torch.bfloat16)`` or ``lm_params_from_arrays(tree,
    dtype=torch.bfloat16)``): casting once gives exactly the values of the
    per-use casts of ``layers.py:132``, ``:339`` and ``:343``, and each
    decode step then reads half the bytes.
    """

    @torch.no_grad()
    def serve_step(params: Params, cache: dict[str, Any], token: torch.Tensor):
        return model.decode_step(params, cache, token)

    return serve_step
