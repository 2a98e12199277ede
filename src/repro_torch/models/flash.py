"""Memory-tiled (flash) attention with its backward pass (counterpart of
``repro.models.flash``).

The JAX package's ``flash_attention`` is a pure-jnp scan over KV blocks
with a custom VJP (``flash.py:37``, backward ``:108``). Here it is a
``torch.autograd.Function``: the forward pass is the port's hand-written
CUDA kernel (:func:`repro_torch.kernels.ops.flash_attention`) asked for
the log-sum-exp as well, and it saves ``(q, k, v, o, lse)`` as the JAX
package's ``_flash_fwd`` does; the backward pass is the three backward
kernels (:func:`repro_torch.kernels.ops.flash_attention_bwd`). A CPU
tensor takes the plain PyTorch versions of both. The kernels mask the
ragged edge themselves, so any S and T work and there is no ``block_kv``
to choose. K and V stay unrepeated: the kernels fold the G query heads of
a kv head and sum their gradients into its dk and dv.

Without a gradient to take (under ``torch.no_grad()``, or when no input
requires one) the call is the serving forward, which writes no
log-sum-exp.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops

__all__ = ["flash_attention"]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand over a strided or expanded gradient; the kernels
        # read rows of 16-byte aligned, contiguous D.
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    causal: bool = True,
) -> torch.Tensor:
    """GQA attention [B, S, H, D] in q's type, differentiable in q, k, v."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return ops.flash_attention(q, k, v, causal=causal)
