"""Batched critical path, the fused §IV-A combined bound and the fleet
engine's stage 1: wrappers of the hand-written CUDA kernels in
``csrc/cpm.cu``.

:func:`batched_critical_path` and :func:`batched_combined_lb` mirror the
JAX package's public wrappers over ``[B, n, n]`` tiles (re-exported by
:mod:`repro_torch.kernels.ops`). :func:`fleet_combined_lb` is the device
program of the scheduler's stage 1
(``repro_torch.core.vectorized._fleet_lb_device``) in one launch: it takes
the candidates' racks and instance ids and the per-instance edge tables,
and never forms the ``[B, n, n]`` adjacency.

A CUDA tensor goes to the kernel (built on first use by
:mod:`repro_torch.kernels.build`) or raises; a CPU tensor goes to the
plain PyTorch version in :mod:`repro_torch.kernels.ref`. There is no
fallback from one to the other. ``launches`` counts kernel launches per
entry point and is touched nowhere else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref

__all__ = [
    "batched_critical_path",
    "batched_combined_lb",
    "fleet_combined_lb",
    "launches",
    "MAX_N",
]

# Kernel launches per entry point (plain integers; the CPU route adds 0).
launches = {
    "combined_lb": 0,
    "combined_lb_masked": 0,
    "critical_path": 0,
    "fleet_lb": 0,
    "fleet_lb_masked": 0,
}

# Largest node count the kernels take (above 32, one thread per node and
# the row's tile in shared memory); the engine's size buckets stay far
# below it.
MAX_N = 128


def _check(
    name: str, t: torch.Tensor, shape: tuple, device: torch.device,
    dtypes: tuple = (torch.float32,),
) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
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


def fleet_combined_lb(
    racks: torch.Tensor,     # int32 [B, n_pad] candidate rack per task (or int64 on the CPU)
    inst_id: torch.Tensor,   # [B], racks' dtype: fleet instance of each row
    src: torch.Tensor,       # int64 [I, m_pad] edge source task (0 on padding)
    dst: torch.Tensor,       # int64 [I, m_pad] edge destination task
    p_src: torch.Tensor,     # f32 [I, m_pad] source-task duration per edge
    c_local: torch.Tensor,   # f32 [I, m_pad] local delay (-inf on padding)
    c_net: torch.Tensor,     # f32 [I, m_pad] optimistic network duration
    net_work: torch.Tensor,  # f32 [I, m_pad] min network duration (0 on padding)
    p_task: torch.Tensor,    # f32 [I, n_pad] task durations (0 on padding)
    chan_div: torch.Tensor,  # f32 [I] 1 + |K| network channels
    pair_ok: torch.Tensor | None = None,  # f32 [I, M_pad, M_pad] topology
    uplift: torch.Tensor | None = None,   # f32 [I, m_pad] forced-wired uplift
    *,
    M_pad: int,
    n_iters: int | None,
    contention: bool,
) -> torch.Tensor:
    """lb[B]: the scheduler's stage-1 bound of every candidate row, from its
    racks and the per-instance tables of
    ``repro_torch.core.vectorized._build_lb_arrays`` (``pair_ok`` and
    ``uplift`` together select the masked body). A CUDA tensor goes to
    ``cpm_fleet_lb`` / ``cpm_fleet_lb_masked``, which read the racks and
    instance ids as int32 (as the engine copies them to the card); a CPU
    tensor, int32 or int64, to :func:`repro_torch.kernels.ref.ref_fleet_lb`."""
    if not isinstance(racks, torch.Tensor) or racks.dim() != 2:
        raise ValueError("racks must be a [B, n_pad] tensor")
    B, n_pad = int(racks.shape[0]), int(racks.shape[1])
    if not 1 <= n_pad <= MAX_N:
        raise ValueError(f"n_pad must be in [1, {MAX_N}], got {n_pad}")
    dev = racks.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    idx = (torch.int32,) if dev.type == "cuda" else (torch.int32, torch.int64)
    _check("racks", racks, (B, n_pad), dev, idx)
    _check("inst_id", inst_id, (B,), dev, (racks.dtype,))
    if not isinstance(src, torch.Tensor) or src.dim() != 2:
        raise ValueError("src must be an [I, m_pad] tensor")
    I, m_pad = int(src.shape[0]), int(src.shape[1])
    _check("src", src, (I, m_pad), dev, (torch.int64,))
    _check("dst", dst, (I, m_pad), dev, (torch.int64,))
    for name, t in (("p_src", p_src), ("c_local", c_local), ("c_net", c_net),
                    ("net_work", net_work)):
        _check(name, t, (I, m_pad), dev)
    _check("p_task", p_task, (I, n_pad), dev)
    _check("chan_div", chan_div, (I,), dev)
    if (pair_ok is None) != (uplift is None):
        raise ValueError("pair_ok and uplift go together")
    if pair_ok is not None:
        _check("pair_ok", pair_ok, (I, M_pad, M_pad), dev)
        _check("uplift", uplift, (I, m_pad), dev)
    iters = ref.clamp_iters(n_pad, n_iters)
    tables = (src, dst, p_src, c_local, c_net, net_work, p_task, chan_div)
    if dev.type == "cpu":
        return ref.ref_fleet_lb(
            racks, inst_id, *tables, pair_ok, uplift,
            M_pad=M_pad, n_iters=iters, contention=contention,
        )
    from repro_torch.kernels.build import load_cpm

    out = torch.empty((B,), dtype=torch.float32, device=dev)
    lib = load_cpm()
    head = (racks.data_ptr(), inst_id.data_ptr(), *(t.data_ptr() for t in tables))
    tail = (out.data_ptr(), B, n_pad, m_pad, int(M_pad), iters, int(bool(contention)),
            _stream(dev))
    if pair_ok is None:
        _raise_if(lib.cpm_fleet_lb(*head, *tail), "cpm_fleet_lb")
        launches["fleet_lb"] += 1
    else:
        _raise_if(
            lib.cpm_fleet_lb_masked(*head, pair_ok.data_ptr(), uplift.data_ptr(), *tail),
            "cpm_fleet_lb_masked",
        )
        launches["fleet_lb_masked"] += 1
    return out
