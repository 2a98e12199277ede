"""Plain PyTorch versions of the cpm kernels.

Twins of ``ref_critical_path`` / ``ref_combined_lb`` of the JAX package,
written in float32 with the kernel's own round loop, non-finite mapping
and association, so that they equal the CUDA kernel (and the Pallas
kernel) bit for bit. The CPU route of :mod:`repro_torch.kernels.cpm` and
the tests use them; ``chip_smoke.py`` holds the kernel against them on
the card.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "clamp_iters", "ref_critical_path", "ref_combined_lb"]

NEG_INF = -1e30


def clamp_iters(n: int, n_iters: int | None) -> int:
    """Relaxation round count: default n - 1, clamped to [0, n - 1]."""
    if n_iters is None:
        n_iters = n - 1
    return max(0, min(int(n_iters), n - 1))


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.full_like(x, NEG_INF))


def _relax(w: torch.Tensor, n_iters: int) -> torch.Tensor:
    B, n, _ = w.shape
    dist = torch.zeros((B, n), dtype=torch.float32, device=w.device)
    for _ in range(n_iters):
        # cand[b, u, v] = dist[b, u] + w[b, u, v]
        cand = dist[:, :, None] + w
        dist = torch.maximum(dist, cand.amax(dim=1))
    return dist


def ref_critical_path(w: torch.Tensor, n_iters: int | None = None) -> torch.Tensor:
    """dist[B, n] after ``n_iters`` Bellman max-plus rounds over w[B, n, n]."""
    w = _finite(w.to(torch.float32))
    return _relax(w, clamp_iters(w.shape[1], n_iters))


def ref_combined_lb(
    w: torch.Tensor,      # [B, n, n] max-plus adjacency (-inf = no edge)
    p: torch.Tensor,      # [B, n] per-row task durations (0 on padding)
    extra: torch.Tensor,  # [B] or [B, 1] contention bound (-inf to disable)
    mask: torch.Tensor | None = None,  # [B, n, n] feasibility uplift (>= 0)
    n_iters: int | None = None,
) -> torch.Tensor:
    """lb[B] = max(max_v dist[v] + p[v], extra), relaxed over ``w + mask``
    when a mask is given; all-padding rows give exactly 0."""
    w = _finite(w.to(torch.float32))
    if mask is not None:
        w = w + mask.to(torch.float32)
    dist = _relax(w, clamp_iters(w.shape[1], n_iters))
    lb = (dist + p.to(torch.float32)).amax(dim=1)
    extra = _finite(extra.to(torch.float32).reshape(-1))
    return torch.maximum(lb, extra)
