"""Memory-tiled (flash) attention, forward pass (counterpart of
``repro.models.flash``).

The JAX package's ``flash_attention`` is a pure-jnp scan over KV blocks
with a custom VJP; here the forward pass is the port's hand-written CUDA
kernel (:func:`repro_torch.kernels.ops.flash_attention`), and a CPU
tensor takes its plain PyTorch version. The kernel masks the ragged edge
itself, so any S and T work and there is no ``block_kv`` to choose.

Only inference is ported: under autograd, with an input that requires a
gradient, this raises. The backward pass (``flash.py:108`` of the JAX
package) is the training slice's ``torch.autograd.Function`` (ROADMAP
Queue 1 item 7).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    causal: bool = True,
) -> torch.Tensor:
    """GQA attention [B, S, H, D] in q's type."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward pass yet: it belongs to the "
            "training slice of the port (ROADMAP Queue 1 item 7); call it "
            "under torch.no_grad() or torch.inference_mode()"
        )
    return ops.flash_attention(q, k, v, causal=causal)
