"""Serving step builders (counterpart of ``build_prefill_step`` and
``build_serve_step`` of ``repro.runtime.steps``).

PyTorch runs eagerly, so a step is a plain function of its state; there
is nothing to jit. The training step (``build_train_step``) belongs to
the training slice (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.lm import Model

__all__ = ["build_prefill_step", "build_serve_step"]

Params = Any


def build_prefill_step(model: Model) -> Callable:
    """prefill_step(params, batch) -> last-position logits [B, 1, V];
    ``batch["memory"]``, where given, is the raw frames or patches."""

    @torch.no_grad()
    def prefill_step(params: Params, batch: dict[str, torch.Tensor]):
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
