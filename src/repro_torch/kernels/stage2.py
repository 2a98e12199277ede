"""Stage 2 of the scheduler's fleet engine, the greedy non-delay evaluator:
the wrapper of the hand-written CUDA kernel in ``csrc/stage2.cu``.

:func:`fleet_evaluate` is the device program of
``repro_torch.core.vectorized._scan_evaluate`` in one launch: it takes the
candidates' racks and instance ids and the per-instance op tables of
``_build_eval_stack``, walks every row's op table and returns each row's
makespan. It is the counterpart of the JAX package's compiled ``lax.scan``
(``src/repro/core/vectorized.py:_scan_evaluate``), which no Pallas kernel
implements.

The kernel reads the op tables packed once a fleet by :func:`pack_tables`
(one blob an instance: a 16-byte-aligned record a table row, then the
instance's channel and reach tables), the racks as int16 and the instance
ids as int32. A CUDA tensor goes to the kernel (built on first use by
:mod:`repro_torch.kernels.build`) or raises; a CPU tensor goes to the plain
PyTorch version :func:`repro_torch.kernels.ref.ref_fleet_evaluate`. There
is no fallback from one to the other. ``launches`` counts kernel launches
and is touched nowhere else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.cpm import (
    _U16, _bits, _check, _floats, _halves, _pair, _raise_if, _stream,
)

__all__ = [
    "MAX_CHANNELS",
    "MAX_STATE_WORDS",
    "PackedTables",
    "fleet_evaluate",
    "launch_plan",
    "launches",
    "pack_tables",
    "packed_words",
    "record_quads",
    "state_words",
    "unpack_tables",
]

# Kernel launches (a plain integer; the CPU route adds 0).
launches = {"fleet_evaluate": 0}

# Largest row state the kernel takes, in 4-byte words (``state_words``):
# one row a block within the card's 227 KB (232,448 bytes) of shared
# memory, ``kMaxWords`` in csrc/stage2.cu. The engine's buckets stay far
# below it: 76 words at the offline bucket, 4,372 at n_pad 128 with the
# m_pad of 4,096 edges (a block then holds 4 rows). It also caps M_pad, a
# power of two in the engine, at 32,768, so every rack id fits in int16.
MAX_STATE_WORDS = 232448 // 4

# Most channels the kernel takes (a rack's channel mask sits above its
# 16-bit id in one word, ``kMaxChan``): 1 wired and up to 15 wireless.
MAX_CHANNELS = 16

_INDEX_TABLES = ("kind", "op_task", "op_edge", "op_src", "op_dst")
_DATA_TABLES = ("op_p", "op_wired", "op_wireless", "op_local")


def state_words(n_pad: int, m_pad: int, M_pad: int, n_chan: int) -> int:
    """Shared-memory words one row holds in the kernel: its racks
    [n_pad], rack_free [M_pad], chan_free [n_chan], task_fin [n_pad] and
    edge_fin [m_pad + 1] (the sentinel column)."""
    return 2 * n_pad + M_pad + n_chan + m_pad + 1


def record_quads(indeg_pad: int) -> int:
    """16-byte quads of one packed op-table row: (kind | task << 16,
    src | dst << 16, edge | n_read << 16, p), (local, wired, wireless, 0),
    then the in-edge ids, one a word, four a quad."""
    return 2 + -(-indeg_pad // 4)


def packed_words(n_ops: int, indeg_pad: int, M_pad: int, n_chan: int) -> int:
    """int32 words of one instance's blob: its records, then n_live,
    chan_free0 [n_chan], reach [M_pad, n_chan] and each rack's channel
    mask [M_pad], padded to a quad."""
    tail = 1 + n_chan + M_pad * n_chan + M_pad
    return 4 * (n_ops * record_quads(indeg_pad) + -(-tail // 4))


@dataclasses.dataclass(frozen=True, eq=False)
class PackedTables:
    """The 12 stage-2 tables of a fleet as the kernel reads them: ``blob``
    int32 [I, packed_words(...)], one 16-byte-aligned blob an instance.
    ``binary_reach``: every reach value is 0 or 1 (the engine's always
    are), which the kernel's channel masks need."""

    blob: torch.Tensor
    n_ops: int
    indeg_pad: int
    M_pad: int
    n_chan: int
    binary_reach: bool

    def to(self, device) -> "PackedTables":
        return dataclasses.replace(self, blob=self.blob.to(device))

    @functools.cached_property
    def tables(self) -> tuple:
        """The 12 tables back (what the plain version reads), once."""
        return unpack_tables(self)


def pack_tables(
    kind, op_task, op_edge, op_src, op_dst, op_p, op_wired, op_wireless, op_local,
    op_in, chan_free0, reach,
) -> PackedTables:
    """Pack the tables of ``_build_eval_stack`` (once a fleet) into the
    blobs the kernel reads, on the tables' device. The kind, task, edge,
    src and dst fields take 16 bits each (every id is below m_pad + 1 <=
    32,769 within the state limit; a larger one raises), the in-edge ids
    32; floats are copied bit for bit. Derived: n_read, a task row's
    count of in-edge ids up to the last first occurrence of an id (the
    ids a max needs: the engine's real in-edges and one sentinel); n_live,
    the count of rows up to an instance's last task or edge row; and each
    rack's mask of the channels it reaches (bit c, for c < 16)."""
    I, n_ops = (int(s) for s in kind.shape)
    indeg_pad = int(op_in.shape[2])
    M_pad, n_chan = int(reach.shape[1]), int(reach.shape[2])
    for name, t, top in zip(_INDEX_TABLES + ("op_in",),
                            (kind, op_task, op_edge, op_src, op_dst, op_in),
                            (_U16,) * 5 + (2**31 - 1,)):
        if t.numel() and (int(t.min()) < 0 or int(t.max()) > top):
            raise ValueError(f"{name} holds an id outside [0, {top}]: it does not pack")
    if indeg_pad > _U16:
        raise ValueError(f"indeg_pad {indeg_pad} does not pack into 16 bits")
    Q = record_quads(indeg_pad)
    dev = kind.device
    k = torch.arange(indeg_pad, device=dev)
    seen = (op_in[..., :, None] == op_in[..., None, :]) & (k[None, :] < k[:, None])
    first = ~seen.any(dim=-1)
    n_read = torch.where(first, k + 1, torch.zeros_like(k)).amax(dim=-1)
    rec = torch.zeros((I, n_ops, 4 * Q), dtype=torch.int32, device=dev)
    rec[..., 0] = _pair(kind, op_task)
    rec[..., 1] = _pair(op_src, op_dst)
    rec[..., 2] = _pair(op_edge, n_read)
    rec[..., 3] = _bits(op_p)
    rec[..., 4] = _bits(op_local)
    rec[..., 5] = _bits(op_wired)
    rec[..., 6] = _bits(op_wireless)
    rec[..., 8:8 + indeg_pad] = op_in.to(torch.int32)
    live = (kind == ref.OP_TASK) | (kind == ref.OP_EDGE)
    pos = torch.arange(1, n_ops + 1, device=dev)
    n_live = torch.where(live, pos, torch.zeros_like(pos)).amax(dim=1)
    tail = torch.zeros((I, packed_words(n_ops, indeg_pad, M_pad, n_chan) - n_ops * 4 * Q),
                       dtype=torch.int32, device=dev)
    tail[:, 0] = n_live.to(torch.int32)
    tail[:, 1:1 + n_chan] = _bits(chan_free0)
    tail[:, 1 + n_chan:1 + n_chan + M_pad * n_chan] = _bits(reach).reshape(I, -1)
    chans = min(n_chan, MAX_CHANNELS)
    weights = torch.tensor([1 << c for c in range(chans)], dtype=torch.int32, device=dev)
    mask = ((reach[..., :chans] > 0).to(torch.int32) * weights).sum(dim=2, dtype=torch.int32)
    tail[:, 1 + n_chan + M_pad * n_chan:1 + n_chan + M_pad * n_chan + M_pad] = mask
    blob = torch.cat([rec.reshape(I, -1), tail], dim=1).contiguous()
    binary = bool(((reach == 0) | (reach == 1)).all())
    return PackedTables(blob, n_ops, indeg_pad, M_pad, n_chan, binary)


def unpack_tables(packed: PackedTables) -> tuple:
    """The 12 tables of ``_build_eval_stack`` from their packed form
    (index tables int64, data float32), equal to what was packed."""
    blob, n_ops, indeg_pad = packed.blob, packed.n_ops, packed.indeg_pad
    M_pad, n_chan = packed.M_pad, packed.n_chan
    I, Q = int(blob.shape[0]), record_quads(indeg_pad)
    rec = blob[:, :n_ops * 4 * Q].reshape(I, n_ops, 4 * Q)
    kind, op_task = _halves(rec[..., 0])
    op_src, op_dst = _halves(rec[..., 1])
    op_edge = _halves(rec[..., 2])[0]

    op_in = rec[..., 8:8 + indeg_pad].to(torch.int64)
    tail = blob[:, n_ops * 4 * Q:]
    chan_free0 = _floats(tail[:, 1:1 + n_chan])
    reach = _floats(tail[:, 1 + n_chan:1 + n_chan + M_pad * n_chan]).reshape(I, M_pad, n_chan)
    return (kind, op_task, op_edge, op_src, op_dst, _floats(rec[..., 3]), _floats(rec[..., 5]),
            _floats(rec[..., 6]), _floats(rec[..., 4]), op_in, chan_free0, reach)


def launch_plan(B: int, n_pad: int, m_pad: int, packed: PackedTables,
                device=None) -> dict:
    """The launch ``fleet_evaluate`` makes on ``device``'s card for these
    sizes: rows a block, blocks, whether a block stages its instance blob,
    dynamic shared memory bytes and the card's SMs."""
    from repro_torch.kernels.build import load

    lib = load("stage2")
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = lib.fleet_evaluate_plan(B, n_pad, packed.n_ops, int(m_pad), packed.M_pad,
                                      packed.indeg_pad, packed.n_chan, out)
    _raise_if(err, "fleet_evaluate_plan")
    return dict(zip(("rows_per_block", "blocks", "staged_blob", "smem_bytes", "sms"), out))


def fleet_evaluate(
    rack: torch.Tensor,        # int16 [B, n_pad] candidate rack per task (int32 / int64 on the CPU)
    inst_id: torch.Tensor,     # int32 [B] fleet instance of each row (int64 beside int64 racks)
    *tables,                   # the 12 tables of _build_eval_stack (CPU only), or one PackedTables
    m_pad: int,
    M_pad: int,
    n_chan: int,
) -> torch.Tensor:
    """makespan[B]: the greedy non-delay schedule of every candidate row.

    ``tables`` is either the 12 tables as
    :func:`repro_torch.kernels.ref.ref_fleet_evaluate` takes them (kind,
    op_task, op_edge, op_src, op_dst: int64 [I, n_ops]; op_p, op_wired,
    op_wireless, op_local: f32 [I, n_ops]; op_in: int64 [I, n_ops,
    indeg_pad]; chan_free0: f32 [I, n_chan]; reach: f32 [I, M_pad,
    n_chan]), or their :class:`PackedTables`. A CUDA tensor goes to
    ``fleet_evaluate`` in csrc/stage2.cu on the current stream of
    ``rack``'s card, which takes int16 racks, int32 instance ids and the
    packed tables only; a CPU tensor, with int16, int32 or int64 racks, to
    the plain version."""
    if not isinstance(rack, torch.Tensor) or rack.dim() != 2:
        raise ValueError("rack must be a [B, n_pad] tensor")
    B, n_pad = int(rack.shape[0]), int(rack.shape[1])
    dev = rack.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    cuda = dev.type == "cuda"
    _check("rack", rack, (B, n_pad), dev,
           (torch.int16,) if cuda else (torch.int16, torch.int32, torch.int64))
    _check("inst_id", inst_id, (B,), dev,
           (torch.int64,) if rack.dtype == torch.int64 else (torch.int32,))
    packed = tables[0] if len(tables) == 1 else None
    if packed is not None:
        if not isinstance(packed, PackedTables) or not isinstance(packed.blob, torch.Tensor):
            raise TypeError("one table argument must be a PackedTables (pack_tables)")
        if (packed.M_pad, packed.n_chan) != (M_pad, n_chan):
            raise ValueError(f"packed tables of M_pad {packed.M_pad}, n_chan "
                             f"{packed.n_chan} passed with M_pad {M_pad}, n_chan {n_chan}")
        n_ops, indeg_pad = packed.n_ops, packed.indeg_pad
        words = packed_words(n_ops, indeg_pad, M_pad, n_chan)
        _check("packed", packed.blob, (int(packed.blob.shape[0]), words), dev, (torch.int32,))
    elif len(tables) == 12:
        if cuda:
            raise TypeError("the CUDA route reads the packed tables: pass "
                            "pack_tables(*tables), made once a fleet")
        kind, op_in = tables[0], tables[9]
        if not isinstance(kind, torch.Tensor) or kind.dim() != 2:
            raise ValueError("kind must be an [I, n_ops] tensor")
        I, n_ops = int(kind.shape[0]), int(kind.shape[1])
        for name, t in zip(_INDEX_TABLES, tables):
            _check(name, t, (I, n_ops), dev, (torch.int64,))
        for name, t in zip(_DATA_TABLES, tables[5:]):
            _check(name, t, (I, n_ops), dev)
        if not isinstance(op_in, torch.Tensor) or op_in.dim() != 3:
            raise ValueError("op_in must be an [I, n_ops, indeg_pad] tensor")
        indeg_pad = int(op_in.shape[2])
        _check("op_in", op_in, (I, n_ops, indeg_pad), dev, (torch.int64,))
        _check("chan_free0", tables[10], (I, n_chan), dev)
        _check("reach", tables[11], (I, M_pad, n_chan), dev)
    else:
        raise TypeError(f"expected the 12 stage-2 tables or one PackedTables, got "
                        f"{len(tables)} table arguments")
    if n_chan < 1 or indeg_pad < 1:
        raise ValueError(f"n_chan and indeg_pad must be >= 1, got {n_chan}, {indeg_pad}")
    words = state_words(n_pad, m_pad, M_pad, n_chan)
    if words > MAX_STATE_WORDS:
        raise ValueError(
            f"stage-2 row state of {words} words (n_pad {n_pad}, m_pad {m_pad}, "
            f"M_pad {M_pad}, n_chan {n_chan}) exceeds the kernel's {MAX_STATE_WORDS}")
    kw = dict(m_pad=m_pad, M_pad=M_pad, n_chan=n_chan)
    if not cuda:
        return ref.ref_fleet_evaluate(
            rack, inst_id, *(tables if packed is None else packed.tables), **kw)
    if n_pad % 8:
        raise ValueError(f"the kernel takes n_pad in multiples of 8, got {n_pad}")
    if n_chan > MAX_CHANNELS:
        raise ValueError(f"the kernel takes at most {MAX_CHANNELS} channels, got {n_chan}")
    if not packed.binary_reach:
        raise ValueError("the kernel takes reach values of 0 and 1 only")
    if rack.data_ptr() % 16 or packed.blob.data_ptr() % 16:
        raise ValueError("rack and the packed tables must start 16-byte aligned")
    from repro_torch.kernels.build import load

    lib = load("stage2")
    with torch.cuda.device(dev):
        out = torch.empty((B,), dtype=torch.float32, device=dev)
        err = lib.fleet_evaluate(
            rack.data_ptr(), inst_id.data_ptr(), packed.blob.data_ptr(), out.data_ptr(),
            B, n_pad, n_ops, int(m_pad), int(M_pad), indeg_pad, int(n_chan), _stream(dev),
        )
    _raise_if(err, "fleet_evaluate")
    launches["fleet_evaluate"] += 1
    return out
