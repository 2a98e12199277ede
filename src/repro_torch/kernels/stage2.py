"""Stage 2 of the scheduler's fleet engine, the greedy non-delay evaluator:
the wrapper of the hand-written CUDA kernel in ``csrc/stage2.cu``.

:func:`fleet_evaluate` is the device program of
``repro_torch.core.vectorized._scan_evaluate`` in one launch: it takes the
candidates' racks and instance ids and the per-instance op tables of
``_build_eval_stack``, walks every row's op table and returns each row's
makespan. It is the counterpart of the JAX package's compiled ``lax.scan``
(``src/repro/core/vectorized.py:_scan_evaluate``), which no Pallas kernel
implements.

A CUDA tensor goes to the kernel (built on first use by
:mod:`repro_torch.kernels.build`) or raises; a CPU tensor goes to the
plain PyTorch version :func:`repro_torch.kernels.ref.ref_fleet_evaluate`.
There is no fallback from one to the other. ``launches`` counts kernel
launches and is touched nowhere else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.cpm import _check, _raise_if, _stream

__all__ = ["fleet_evaluate", "launches", "MAX_STATE_WORDS", "state_words"]

# Kernel launches (a plain integer; the CPU route adds 0).
launches = {"fleet_evaluate": 0}

# Largest row state the kernel takes, in 4-byte words (``state_words``):
# one row a block within the card's 227 KB (232,448 bytes) of shared
# memory, ``kMaxWords`` in csrc/stage2.cu. The engine's buckets stay far
# below it: 76 words at the offline bucket, 4,372 at n_pad 128 with the
# m_pad of 4,096 edges (a block then holds 4 rows).
MAX_STATE_WORDS = 232448 // 4

_INDEX_TABLES = ("kind", "op_task", "op_edge", "op_src", "op_dst")
_DATA_TABLES = ("op_p", "op_wired", "op_wireless", "op_local")


def state_words(n_pad: int, m_pad: int, M_pad: int, n_chan: int) -> int:
    """Shared-memory words one row holds in the kernel: its racks
    [n_pad], rack_free [M_pad], chan_free [n_chan], task_fin [n_pad] and
    edge_fin [m_pad + 1] (the sentinel column)."""
    return 2 * n_pad + M_pad + n_chan + m_pad + 1


def fleet_evaluate(
    rack: torch.Tensor,        # int32 [B, n_pad] candidate rack per task (or int64 on the CPU)
    inst_id: torch.Tensor,     # [B], rack's dtype: fleet instance of each row
    kind: torch.Tensor,        # int64 [I, n_ops] OP_TASK / OP_EDGE / OP_PAD
    op_task: torch.Tensor,     # int64 [I, n_ops]
    op_edge: torch.Tensor,     # int64 [I, n_ops]
    op_src: torch.Tensor,      # int64 [I, n_ops]
    op_dst: torch.Tensor,      # int64 [I, n_ops]
    op_p: torch.Tensor,        # f32 [I, n_ops]
    op_wired: torch.Tensor,    # f32 [I, n_ops]
    op_wireless: torch.Tensor,  # f32 [I, n_ops]
    op_local: torch.Tensor,    # f32 [I, n_ops]
    op_in: torch.Tensor,       # int64 [I, n_ops, indeg_pad] (sentinel m_pad)
    chan_free0: torch.Tensor,  # f32 [I, n_chan] 0 = usable, +inf = masked
    reach: torch.Tensor,       # f32 [I, M_pad, n_chan] topology reachability
    *,
    m_pad: int,
    M_pad: int,
    n_chan: int,
) -> torch.Tensor:
    """makespan[B]: the greedy non-delay schedule of every candidate row
    (the tables as :func:`repro_torch.kernels.ref.ref_fleet_evaluate` takes
    them). A CUDA tensor goes to ``fleet_evaluate`` in csrc/stage2.cu on
    the current stream of ``rack``'s card, which reads the racks and
    instance ids as int32 (as the engine copies them to the card); a CPU
    tensor, int32 or int64, to the plain version."""
    if not isinstance(rack, torch.Tensor) or rack.dim() != 2:
        raise ValueError("rack must be a [B, n_pad] tensor")
    B, n_pad = int(rack.shape[0]), int(rack.shape[1])
    dev = rack.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    idx = (torch.int32,) if dev.type == "cuda" else (torch.int32, torch.int64)
    _check("rack", rack, (B, n_pad), dev, idx)
    _check("inst_id", inst_id, (B,), dev, (rack.dtype,))
    if not isinstance(kind, torch.Tensor) or kind.dim() != 2:
        raise ValueError("kind must be an [I, n_ops] tensor")
    I, n_ops = int(kind.shape[0]), int(kind.shape[1])
    tables = (kind, op_task, op_edge, op_src, op_dst, op_p, op_wired, op_wireless,
              op_local, op_in, chan_free0, reach)
    for name, t in zip(_INDEX_TABLES, tables):
        _check(name, t, (I, n_ops), dev, (torch.int64,))
    for name, t in zip(_DATA_TABLES, tables[5:]):
        _check(name, t, (I, n_ops), dev)
    if not isinstance(op_in, torch.Tensor) or op_in.dim() != 3:
        raise ValueError("op_in must be an [I, n_ops, indeg_pad] tensor")
    indeg_pad = int(op_in.shape[2])
    _check("op_in", op_in, (I, n_ops, indeg_pad), dev, (torch.int64,))
    _check("chan_free0", chan_free0, (I, n_chan), dev)
    _check("reach", reach, (I, M_pad, n_chan), dev)
    if n_chan < 1 or indeg_pad < 1:
        raise ValueError(f"n_chan and indeg_pad must be >= 1, got {n_chan}, {indeg_pad}")
    words = state_words(n_pad, m_pad, M_pad, n_chan)
    if words > MAX_STATE_WORDS:
        raise ValueError(
            f"stage-2 row state of {words} words (n_pad {n_pad}, m_pad {m_pad}, "
            f"M_pad {M_pad}, n_chan {n_chan}) exceeds the kernel's {MAX_STATE_WORDS}")
    if dev.type == "cpu":
        return ref.ref_fleet_evaluate(rack, inst_id, *tables, m_pad=m_pad, M_pad=M_pad,
                                      n_chan=n_chan)
    from repro_torch.kernels.build import load

    lib = load("stage2")
    with torch.cuda.device(dev):
        out = torch.empty((B,), dtype=torch.float32, device=dev)
        err = lib.fleet_evaluate(
            rack.data_ptr(), inst_id.data_ptr(), *(t.data_ptr() for t in tables),
            out.data_ptr(), B, n_pad, n_ops, int(m_pad), int(M_pad), indeg_pad, int(n_chan),
            _stream(dev),
        )
    _raise_if(err, "fleet_evaluate")
    launches["fleet_evaluate"] += 1
    return out
