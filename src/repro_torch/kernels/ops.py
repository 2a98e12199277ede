"""Public entry points of the port's kernels (counterpart of
``repro.kernels.ops``).

Same signatures as the JAX package's wrappers; ``flash_attention_bwd``
(flash attention's gradient, which the JAX package computes in jnp, not
in a Pallas kernel) has none to match. The tensor's device picks
the route: the hand-written CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor (see :mod:`repro_torch.kernels.cpm` and
:mod:`repro_torch.kernels.attention`). The TPU compiler-parameter shim of
the JAX package has no counterpart.
"""

from __future__ import annotations

from repro_torch.kernels.attention import (
    decode_attention,
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.cpm import batched_combined_lb, batched_critical_path

__all__ = [
    "flash_attention",
    "flash_attention_bwd",
    "decode_attention",
    "batched_critical_path",
    "batched_combined_lb",
]
