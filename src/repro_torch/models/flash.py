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

Under a mesh (q a DTensor) the kernels run on each rank's local shard.
q, k and v are first placed as the JAX package's ``_flash_fwd`` places
its residuals (``flash.py:98-104``): batch over the data axes, heads over
'model' (``shard(·, "act_heads")``). Attention is independent per (row,
head), so each rank's local result is exact, and the residuals the
autograd Function saves (q, k, v, o and the lse [B, S, H]) are the local
shards of the ``act_heads`` / ``act_lse`` placements. The JAX package
repeats K/V to H heads before flash; here K/V keep their KV heads where
the heads' mesh extent divides KV (each rank's query heads then fold onto
its own KV heads with the same G), and are repeated to H heads on this
route only where it does not.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

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
    if isinstance(q, DTensor):
        return _sharded(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return ops.flash_attention(q, k, v, causal=causal)


def _sharded(q: DTensor, k: DTensor, v: DTensor, causal: bool) -> DTensor:
    """:func:`flash_attention` of DTensors: the kernels on the local shards
    of q, k and v placed alike (batch and heads split, nothing else)."""
    from repro_torch.models.layers import shard  # layers imports this module

    q = shard(q, "act_heads")
    mesh = q.device_mesh
    # Without an act_heads rule q may arrive split elsewhere (or Partial):
    # only the batch and head splits keep attention local.
    pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in q.placements]
    q = q.redistribute(mesh, pl)
    H, KV = q.shape[2], k.shape[2]
    heads_split = 1
    for i, p in enumerate(pl):
        if p.is_shard(2):
            heads_split *= mesh.size(i)
    if H != KV and KV % heads_split:
        # The reference's repeat (layers.py:250-253): heads over 'model'
        # cannot split the KV heads evenly, so each query head gets its own.
        kv_pl = [Replicate() if p.is_shard(2) else p for p in pl]
        k, v = (DTensor.from_local(
            torch.repeat_interleave(t.redistribute(mesh, kv_pl).to_local(), H // KV, dim=2),
            mesh, kv_pl, run_check=False) for t in (k, v))
    k, v = k.redistribute(mesh, pl), v.redistribute(mesh, pl)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (ql, kl, vl)):
        ol = _FlashAttention.apply(ql, kl, vl, causal)
    else:
        ol = ops.flash_attention(ql, kl, vl, causal=causal)
    return DTensor.from_local(ol, mesh, pl, run_check=False)
