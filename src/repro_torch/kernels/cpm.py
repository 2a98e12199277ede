"""Batched critical path and the fused §IV-A combined bound: wrappers of
the hand-written CUDA kernels in ``csrc/cpm.cu``.

A CUDA tensor goes to the kernel (built on first use by
:mod:`repro_torch.kernels.build`) or raises; a CPU tensor goes to the
plain PyTorch version in :mod:`repro_torch.kernels.ref`. There is no
fallback from one to the other. ``launches`` counts kernel launches per
entry point and is touched nowhere else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref

__all__ = ["batched_critical_path", "batched_combined_lb", "launches", "MAX_N"]

# Kernel launches per entry point (plain integers; the CPU route adds 0).
launches = {"combined_lb": 0, "combined_lb_masked": 0, "critical_path": 0}

# Largest node count the kernel takes (one thread per node, the row's tile
# in shared memory); the engine's size buckets stay far below it.
MAX_N = 128


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_w(w: torch.Tensor) -> tuple[int, int]:
    if not isinstance(w, torch.Tensor) or w.dim() != 3 or w.shape[1] != w.shape[2]:
        raise ValueError("w must be a [B, n, n] tensor")
    B, n = int(w.shape[0]), int(w.shape[1])
    if not 1 <= n <= MAX_N:
        raise ValueError(f"n must be in [1, {MAX_N}], got {n}")
    _check("w", w, (B, n, n), w.device)
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {w.device}")
    return B, n


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_if(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError {err}")


def batched_critical_path(
    w: torch.Tensor, block_b: int = 8, n_iters: int | None = None
) -> torch.Tensor:
    """dist[B, n]: longest path into each node after ``n_iters`` Bellman
    max-plus rounds (default n - 1). ``block_b`` is accepted for signature
    parity with the JAX package; the CUDA kernel sizes its own blocks."""
    B, n = _check_w(w)
    iters = ref.clamp_iters(n, n_iters)
    if w.device.type == "cpu":
        return ref.ref_critical_path(w, iters)
    from repro_torch.kernels.build import load_cpm

    out = torch.empty((B, n), dtype=torch.float32, device=w.device)
    lib = load_cpm()
    err = lib.cpm_critical_path(
        w.data_ptr(), out.data_ptr(), B, n, iters, _stream(w.device)
    )
    _raise_if(err, "cpm_critical_path")
    launches["critical_path"] += 1
    return out


def batched_combined_lb(
    w: torch.Tensor,      # [B, n, n] float32 max-plus adjacency (-inf = no edge)
    p: torch.Tensor,      # [B, n] float32 per-row task durations (0 on padding)
    extra: torch.Tensor,  # [B] or [B, 1] float32 contention bound (-inf to disable)
    mask: torch.Tensor | None = None,  # [B, n, n] float32 feasibility uplift
    block_b: int = 8,
    n_iters: int | None = None,
) -> torch.Tensor:
    """lb[B] = max(max_v dist[v] + p[v], extra): the §IV-A combined
    stage-1 bound, relaxed over ``w + mask`` when a mask is given.
    ``block_b`` and ``n_iters`` as in :func:`batched_critical_path`."""
    B, n = _check_w(w)
    dev = w.device
    _check("p", p, (B, n), dev)
    if tuple(extra.shape) == (B, 1):
        extra = extra.reshape(B)
    _check("extra", extra, (B,), dev)
    if mask is not None:
        _check("mask", mask, (B, n, n), dev)
    iters = ref.clamp_iters(n, n_iters)
    if dev.type == "cpu":
        return ref.ref_combined_lb(w, p, extra, mask=mask, n_iters=iters)
    from repro_torch.kernels.build import load_cpm

    out = torch.empty((B,), dtype=torch.float32, device=dev)
    lib = load_cpm()
    if mask is None:
        err = lib.cpm_combined_lb(
            w.data_ptr(), p.data_ptr(), extra.data_ptr(), out.data_ptr(),
            B, n, iters, _stream(dev),
        )
        _raise_if(err, "cpm_combined_lb")
        launches["combined_lb"] += 1
    else:
        err = lib.cpm_combined_lb_masked(
            w.data_ptr(), mask.data_ptr(), p.data_ptr(), extra.data_ptr(),
            out.data_ptr(), B, n, iters, _stream(dev),
        )
        _raise_if(err, "cpm_combined_lb_masked")
        launches["combined_lb_masked"] += 1
    return out
