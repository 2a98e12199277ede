# Ported from src/repro/core/vectorized.py: host driver copied, device programs rewritten in PyTorch.
"""Batched schedule search on the device (beyond-paper), in PyTorch.

The paper's solver is host-side B&B. On an accelerator the natural
adaptation of its *search* is massive data parallelism: evaluate tens of
thousands of candidate rack assignments simultaneously as one batched tensor
program. This module implements that search as a two-stage batch engine
whose padding and masking are **instance-aware end-to-end**: a fleet of
heterogeneous :class:`ProblemInstance`\\ s is packed into one padded
mega-batch (shared size bucket, per-row instance ids, per-instance channel
masks) and solved by one pair of device programs per size bucket.

  Stage 1 (bound): every candidate passes through the paper's combined
  §IV-A lower bound, computed batched on the device in one launch of the
  hand-written CUDA kernel :func:`repro_torch.kernels.cpm.fleet_combined_lb`,
  which builds each candidate's max-plus adjacency and contention terms on
  chip from its racks (int16, copied from the same pinned host buffer as
  stage 2's) and its instance's edge tables (packed once a fleet) — the
  critical-path bound (iterated max-plus relaxation over the DAG's edges,
  equal to the dense relaxation bit for bit) maxed with the contention
  terms (per-rack work, aggregate
  wired+wireless channel work; see :mod:`repro_torch.core.bounds` for the
  §IV-A term-to-array mapping). Candidates whose bound already meets the
  running incumbent are discarded without ever being scheduled; the
  contention terms are what let dense instances (where the contention-free
  critical path prunes 0%) prune.

  Stage 2 (evaluate): survivors are scored by a greedy non-delay schedule
  executed in lock-step across the batch: a walk over *static op tables*
  in the shared layout of :func:`repro_torch.core.simulator.pad_op_tables`
  — per-instance tables are stacked on a leading axis and read per batch
  row by instance id, so candidates of **different** jobs ride in the
  same launch. On a card it is one launch of the hand-written CUDA kernel
  :func:`repro_torch.kernels.stage2.fleet_evaluate` per card, one thread a
  row walking its instance's packed op records from shared memory with
  its state there too, the rows copied in as int16 from a pinned host
  buffer; on the CPU its plain version is a PyTorch loop, one step of
  gathers and scatters per op-table row.

Every device operation is an add, a max, a compare, an argmin or one
division in a fixed order, so scores, bounds and hence the whole search
equal the JAX package bit for bit, on the CPU and on the card.

Fleet API: :func:`schedule_fleet` runs N heterogeneous instances through
the lockstep driver — per-instance incumbents, pruning and refinement
evolve exactly as in the single-instance :func:`vectorized_search` (which
is the fleet-of-one special case), so each per-instance result is
bit-for-bit identical to solving that instance alone, while the fleet pays
one launch per stage per lockstep round instead of one per instance.
:class:`FleetResult` reports per-instance results plus fleet prune /
launch / trace counters. A "trace" here is the first use of a size-bucket
key (dims plus batch rows) in the process: a fleet costs at most one per
stage, and 0 when a fleet in the same bucket ran before.

  Refinement (sampled regime): the incumbent stream feeds the strategy
  portfolio of :mod:`repro_torch.core.portfolio` — mutation local search by
  default (bit-for-bit the pre-portfolio loop), optionally elite
  crossover and simulated annealing with a multiplicative-weights budget
  allocator (``strategies="portfolio"``). All strategies' proposals ride
  the same lockstep launches and the same stage-1 pruner; per-strategy
  counters surface as ``strategy_stats`` on the results.

This module is an *incumbent generator / pruner*: the winning assignment is
re-executed exactly with the host simulator and verified by the OP checker.
Pruning is exact with respect to the greedy objective: greedy(c) >= LB(c),
so LB(c) >= incumbent implies c cannot improve the incumbent.

Every entry point takes ``device=None`` (the CUDA card; see
:func:`repro_torch.device.resolve_device`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import bounds as bounds_mod
from repro_torch.core import portfolio as portfolio_mod
from repro_torch.core.instance import ProblemInstance
from repro_torch.core.schedule import Schedule
from repro_torch.core.simulator import build_op_tables, pad_op_tables, simulate
from repro_torch.device import resolve_device
from repro_torch.kernels import cpm as kcpm
from repro_torch.kernels import stage2 as kstage2
from repro_torch.obs.trace import as_tracer

__all__ = [
    "enumerate_assignments",
    "sample_assignments",
    "make_batched_evaluator",
    "batched_lower_bound",
    "vectorized_search",
    "schedule_fleet",
    "VectorizedResult",
    "FleetResult",
]


def enumerate_assignments(n: int, max_racks: int, limit: int | None = None) -> np.ndarray:
    """All canonical task->rack assignments (restricted growth strings).

    Canonical = rack labels appear in first-use order, which quotients out
    rack-relabelling symmetry. Returns int32[count, n].
    """
    out: list[list[int]] = []

    def rec(prefix: list[int], n_used: int) -> None:
        if limit is not None and len(out) >= limit:
            return
        if len(prefix) == n:
            out.append(list(prefix))
            return
        for i in range(min(n_used + 1, max_racks)):
            prefix.append(i)
            rec(prefix, max(n_used, i + 1))
            prefix.pop()
            if limit is not None and len(out) >= limit:
                return

    rec([], 0)
    return np.asarray(out, dtype=np.int32).reshape(-1, n)


def sample_assignments(
    rng: np.random.Generator, n: int, max_racks: int, count: int
) -> np.ndarray:
    """Random assignments (not canonicalized; used when enumeration is big)."""
    return rng.integers(0, max_racks, size=(count, n), dtype=np.int32).astype(np.int32)


# ---------------------------------------------------------------------------
# Size buckets
# ---------------------------------------------------------------------------

def _bucket(x: int, lo: int = 8) -> int:
    """Smallest power of two >= max(x, lo): the size-bucket rounding used for
    every padded dimension so fleets of similar size share one bucket."""
    b = lo
    while b < x:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class _FleetDims:
    """Shared size bucket of a (possibly heterogeneous) instance fleet.

    Every padded dimension is the bucket of the fleet-wide maximum, so all
    instances share one op-table layout and one device program per stage.
    ``n_iters`` is the true relaxation depth bound (max task count - 1):
    extra rounds past an instance's own depth are exact no-ops, which keeps
    per-instance bounds bit-identical under any fleet padding.
    """

    n_ops: int
    n_pad: int
    m_pad: int
    M_pad: int
    indeg_pad: int
    n_chan: int
    n_iters: int


def _fleet_dims(instances, use_wireless: bool, op_tables=None) -> _FleetDims:
    """Size bucket of a fleet. ``op_tables`` (one prebuilt ``OpTables`` per
    instance) sizes the evaluator dims; LB-only callers omit it and must
    not read ``n_ops`` / ``indeg_pad`` (they stay at the bucket floor)."""
    n_ops = n = m = M = indeg = wireless = 1
    for i, inst in enumerate(instances):
        if op_tables is not None:
            n_ops = max(n_ops, op_tables[i].n_ops)
            indeg = max(indeg, op_tables[i].task_in_edges.shape[1])
        n = max(n, inst.job.n_tasks)
        m = max(m, inst.job.n_edges)
        M = max(M, inst.n_racks)
        if use_wireless:
            wireless = max(wireless, inst.n_wireless)
    return _FleetDims(
        n_ops=_bucket(n_ops),
        n_pad=_bucket(n),
        m_pad=_bucket(m),
        M_pad=_bucket(M, lo=2),
        indeg_pad=_bucket(indeg, lo=4),
        n_chan=1 + (wireless if use_wireless else 0),
        n_iters=max(0, n - 1),
    )


# ---------------------------------------------------------------------------
# Size-bucket accounting
# ---------------------------------------------------------------------------

# Counted once per new size-bucket key (device, every argument shape and
# the static dims) of the stage-2 evaluator and the stage-1 bound program:
# the counterpart of a fresh jit trace, so fleets sharing a bucket count 0.
TRACE_COUNT = 0
LB_TRACE_COUNT = 0
_seen_stage2: set = set()
_seen_stage1: set = set()


def _bucket_key(device, tensors, statics) -> tuple:
    shapes = tuple(None if t is None else tuple(t.shape) for t in tensors)
    return (str(device),) + shapes + tuple(statics)


# ---------------------------------------------------------------------------
# Stage-2 evaluator: instance-aware op-table program
# ---------------------------------------------------------------------------

def _scan_evaluate(
    rack,       # int16[B, n_pad]  candidate assignments (one job's tasks per row;
                #                  the engine's rows: _FleetRows; int32 / int64 on the CPU)
    inst_id,    # int32[B]         which fleet instance each row belongs to
    *tables,    # the 12 tables below (the plain version's) or their
                # kstage2.PackedTables (the engine's, made once a fleet):
                # kind,       int64[I, n_ops]  OP_TASK / OP_EDGE / OP_PAD
                # op_task, op_edge, op_src, op_dst: int64[I, n_ops] ids (0 off their kind)
                # op_p, op_wired, op_wireless, op_local: f32[I, n_ops] durations
                # op_in,      int64[I, n_ops, indeg_pad] in-edge ids gating a task
                #             row; the sentinel id m_pad always reads 0.0
                # chan_free0, f32[I, n_chan] 0 = usable, +inf = masked channel
                # reach,      f32[I, M_pad, n_chan] topology reachability: 1 = rack
                #             may use the channel (col 0, wired, always 1)
    m_pad: int,
    M_pad: int,
    n_chan: int,
):
    """makespan[B]: the greedy non-delay schedule of every row, the
    reference's ``lax.scan`` over the op tables, in one launch of the CUDA
    kernel :func:`repro_torch.kernels.stage2.fleet_evaluate`; on the CPU
    its plain version :func:`repro_torch.kernels.ref.ref_fleet_evaluate`
    walks the tables one step of PyTorch ops per op-table row."""
    global TRACE_COUNT
    if len(tables) == 1:
        pk = tables[0]
        shapes, statics = (rack, pk.blob), (pk.n_ops, pk.indeg_pad)
    else:
        shapes, statics = (rack, tables[0], tables[9], tables[11]), ()
    key = _bucket_key(rack.device, shapes, statics + (m_pad, M_pad, n_chan))
    if key not in _seen_stage2:
        _seen_stage2.add(key)
        TRACE_COUNT += 1
    return kstage2.fleet_evaluate(rack, inst_id, *tables, m_pad=m_pad, M_pad=M_pad,
                                  n_chan=n_chan)


def _build_eval_stack(instances, dims: _FleetDims, use_wireless: bool, device, op_tables=None):
    """Stacked device op tables [I, ...] in ``_scan_evaluate`` order, moved
    to ``device`` once per fleet (index tables as int64, data as f32)."""
    I = len(instances)
    fields = {
        "kind": np.zeros((I, dims.n_ops), np.int32),
        "op_task": np.zeros((I, dims.n_ops), np.int32),
        "op_edge": np.zeros((I, dims.n_ops), np.int32),
        "op_src": np.zeros((I, dims.n_ops), np.int32),
        "op_dst": np.zeros((I, dims.n_ops), np.int32),
        "op_p": np.zeros((I, dims.n_ops), np.float32),
        "op_wired": np.zeros((I, dims.n_ops), np.float32),
        "op_wireless": np.zeros((I, dims.n_ops), np.float32),
        "op_local": np.zeros((I, dims.n_ops), np.float32),
        "op_in": np.zeros((I, dims.n_ops, dims.indeg_pad), np.int32),
    }
    chan_free0 = np.full((I, dims.n_chan), np.inf, np.float32)
    reach = np.ones((I, dims.M_pad, dims.n_chan), np.float32)
    for i, inst in enumerate(instances):
        t = pad_op_tables(
            inst,
            n_ops=dims.n_ops,
            indeg_pad=dims.indeg_pad,
            edge_sentinel=dims.m_pad,
            tables=None if op_tables is None else op_tables[i],
        )
        for name in fields:
            fields[name][i] = getattr(t, name)
        n_ch = 1 + (inst.n_wireless if use_wireless else 0)
        chan_free0[i, :n_ch] = 0.0
        if inst.topology is not None and n_ch > 1:
            reach[i, : inst.n_racks, 1:n_ch] = inst.topology.reach
    return tuple(_to_device(fields[name], device) for name in fields) + (
        _to_device(chan_free0, device),
        _to_device(reach, device),
    )


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> device tensor: integer arrays become int64 indices,
    float arrays stay float32."""
    a = np.asarray(a)
    dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.as_tensor(a).to(device=device, dtype=dtype)


def _stage2_devices(device: torch.device) -> list[torch.device]:
    """The devices stage 2 splits its rows over: this process's local
    cards (the reference's ``shard_map`` over ``jax.local_devices()``,
    ``vectorized.py:298-328``). A process owns every visible card unless
    it names one (``cuda:i``) or runs in a process group of more than one
    rank (one process a card); then it keeps stage 2 on ``device``, as it
    does on the CPU. Otherwise the current card comes first, since the
    first chunk's tables are placed on ``device``."""
    if (device.type != "cuda" or device.index is not None
            or (dist.is_initialized() and dist.get_world_size() > 1)):
        return [device]
    first = torch.cuda.current_device()
    return [torch.device("cuda", first)] + [
        torch.device("cuda", i) for i in range(torch.cuda.device_count()) if i != first]


def _stage2_tables(tables: tuple, devs: list) -> list[tuple]:
    """The op tables of ``_build_eval_stack`` packed once a fleet
    (:func:`repro_torch.kernels.stage2.pack_tables`, on the tables' device)
    and placed on each of ``devs`` (replicated, as the reference's
    ``shard_map`` replicates them): one ``(PackedTables,)`` a device."""
    packed = kstage2.pack_tables(*tables)
    return [(packed.to(d),) for d in devs]


class _FleetRows:
    """Host buffers of the engine's candidate rows, written in place every
    launch of either stage: int16 racks [B, n_pad] (every rack id fits:
    the kernels' state limits cap M_pad at 32,768) and int32 instance ids
    [B], and the float32 bounds or scores read back. For a CUDA device they
    are allocated pinned, once, so each card's slice goes with
    ``non_blocking=True``; on the CPU they are plain host memory (pinning
    needs CUDA)."""

    def __init__(self, B: int, n_pad: int, device: torch.device):
        pin = device.type == "cuda"
        self.rack = torch.zeros((B, n_pad), dtype=torch.int16, pin_memory=pin)
        self.iid = torch.zeros(B, dtype=torch.int32, pin_memory=pin)
        self.out = torch.empty(B, dtype=torch.float32, pin_memory=pin)
        self.rack_np, self.iid_np, self.out_np = (
            self.rack.numpy(), self.iid.numpy(), self.out.numpy())
        self.pinned = pin
        self._copied: list = []  # events after the last copies out of the buffers

    def fill(self, blocks, n_pad: int, span: int = 0) -> None:
        """Rows ``[lo, lo + len(block))`` of instance ``idx`` for each
        ``(lo, block, n, idx)``, tasks past ``n`` on rack 0, and the rows
        after them up to ``lo + span`` all on rack 0 of instance ``idx``
        (stage 1's kernel stages one instance's tables a block); every
        other row all on rack 0 of instance 0."""
        rack, iid = self.rack_np, self.iid_np
        end = 0
        for lo, block, n, idx in blocks:
            hi = lo + block.shape[0]
            rack[end:lo] = 0
            iid[end:lo] = 0
            rack[lo:hi, :n] = block
            rack[lo:hi, n:n_pad] = 0
            iid[lo:hi] = idx
            end = max(hi, lo + span)
            rack[hi:end] = 0
            iid[hi:end] = idx
        rack[end:] = 0
        iid[end:] = 0

    def mark(self, devs: list) -> None:
        """Record, on each card's current stream, that the launch's copies
        out of the buffers are queued (what :meth:`wait` waits for)."""
        if self.pinned:
            self._copied = [torch.cuda.current_stream(d).record_event() for d in devs]

    def wait(self) -> None:
        for ev in self._copied:
            ev.synchronize()
        self._copied = []

    def read(self, parts: list[torch.Tensor]) -> np.ndarray:
        """The bounds or scores of one launch's chunks, in order, on the
        host: into the pinned buffer (each card's copy queued, then each
        card waited for; a view, valid until the next read), or
        concatenated on the CPU."""
        if not self.pinned:
            return np.concatenate([p.numpy() for p in parts])
        lo = 0
        for p in parts:
            self.out[lo:lo + p.shape[0]].copy_(p, non_blocking=True)
            lo += p.shape[0]
        for p in parts:
            torch.cuda.current_stream(p.device).synchronize()
        return self.out_np[:lo]


def _stage2_split(rack: torch.Tensor, iid: torch.Tensor, tables_on: list, devs: list,
                  dims: "_FleetDims") -> list[torch.Tensor]:
    """Stage 2 over ``len(devs)`` equal row chunks in order, chunk i on
    ``devs[i]``; every chunk is launched before any is read. ``rack``
    (int16) and ``iid`` (int32) are host tensors, pinned for a card
    (:class:`_FleetRows`): each chunk is copied with
    ``non_blocking=True`` (on the CPU it is a view). Each row is scored on
    its own, so the chunks' scores concatenated are the one-chunk scores
    bit for bit. (Each card's program counts as its own size bucket in
    ``TRACE_COUNT``.)"""
    per = rack.shape[0] // len(devs)
    return [
        _scan_evaluate(
            rack[i * per:(i + 1) * per].to(d, non_blocking=True),
            iid[i * per:(i + 1) * per].to(d, non_blocking=True),
            *tables_on[i], m_pad=dims.m_pad, M_pad=dims.M_pad, n_chan=dims.n_chan,
        )
        for i, d in enumerate(devs)
    ]


def make_batched_evaluator(inst: ProblemInstance, use_wireless: bool = True, device=None):
    """Build a fn: rack[B, n] int -> makespan[B] float32 (greedy non-delay).

    The fleet-of-one special case of the mega-batch evaluator: pads its
    batch to the instance's size bucket (batch to a power of two times the
    local card count) and runs the shared stage-2 program, its rows split
    over the local cards — instances of similar size share one size
    bucket. The returned scores are a tensor on ``device``.
    """
    dev = resolve_device(device)
    ops = [build_op_tables(inst)]
    dims = _fleet_dims([inst], use_wireless, ops)
    devs = _stage2_devices(dev)
    n_dev = len(devs)
    tables_on = _stage2_tables(_build_eval_stack([inst], dims, use_wireless, "cpu", ops), devs)
    n = inst.job.n_tasks
    rows = None  # _FleetRows, grown to the largest padded batch seen

    def evaluate(rack) -> torch.Tensor:
        nonlocal rows
        rack = np.asarray(rack)
        B = rack.shape[0]
        B_pad = _bucket(B) * (n_dev if _bucket(B) % n_dev else 1)
        if rows is None or rows.rack.shape[0] < B_pad:
            rows = _FleetRows(B_pad, dims.n_pad, dev)
        # The scores stay on the card unread, so the buffers are reused only
        # once the previous call's copies out of them have run.
        rows.wait()
        rows.fill([(0, rack, n, 0)], dims.n_pad)
        parts = _stage2_split(rows.rack[:B_pad], rows.iid[:B_pad], tables_on, devs, dims)
        rows.mark(devs)
        return torch.cat([p.to(dev) for p in parts])[:B]

    evaluate.dims = dims
    return evaluate


# ---------------------------------------------------------------------------
# Stage-1 bound: the combined §IV-A bound over the mega-batch
# ---------------------------------------------------------------------------

def _build_lb_arrays(instances, dims: _FleetDims, device):
    """Stacked stage-1 arrays [I, ...] for ``_fleet_lb_device``, moved to
    ``device`` once per fleet.

    Padded edges carry -inf costs (their scatter into the max-plus adjacency
    is a no-op) and zero ``net_work`` (they add nothing to the aggregate
    channel-work term); padded tasks carry zero duration.

    When any instance carries a :class:`~repro_torch.core.instance.Topology`,
    two extra arrays feed the matching-feasibility mask of the kernel:
    ``pair_ok[I, M_pad, M_pad]`` (1 = the rack pair shares at least one
    reachable subchannel; all-ones for topology-free instances) and
    ``uplift[I, m_pad]`` (the forced-wired uplift ``q - min(q, q̌)`` per
    edge, 0 on padding). Topology-free fleets omit them and run the
    unmasked kernel.
    """
    I = len(instances)
    src = np.zeros((I, dims.m_pad), np.int32)
    dst = np.zeros((I, dims.m_pad), np.int32)
    p_src = np.zeros((I, dims.m_pad), np.float32)
    c_local = np.full((I, dims.m_pad), -np.inf, np.float32)
    c_net = np.full((I, dims.m_pad), -np.inf, np.float32)
    net_work = np.zeros((I, dims.m_pad), np.float32)
    p_task = np.zeros((I, dims.n_pad), np.float32)
    chan_div = np.ones(I, np.float32)
    topo_on = any(inst.topology is not None for inst in instances)
    pair_ok = np.ones((I, dims.M_pad, dims.M_pad), np.float32) if topo_on else None
    uplift = np.zeros((I, dims.m_pad), np.float32) if topo_on else None
    for i, inst in enumerate(instances):
        job = inst.job
        m = job.n_edges
        p_task[i, : job.n_tasks] = job.p
        chan_div[i] = 1 + inst.n_wireless
        if m:
            src[i, :m] = job.edges[:, 0]
            dst[i, :m] = job.edges[:, 1]
            p_src[i, :m] = job.p[job.edges[:, 0]]
            c_local[i, :m] = inst.r_local
            net = bounds_mod.min_network_durations(inst)
            c_net[i, :m] = net
            net_work[i, :m] = net
            if topo_on:
                uplift[i, :m] = np.asarray(inst.q_wired, np.float32) - net
        if topo_on and inst.topology is not None:
            M = inst.n_racks
            pair_ok[i, :M, :M] = inst.topology.pair_connected()
    out = (src, dst, p_src, c_local, c_net, net_work, p_task, chan_div)
    if topo_on:
        out = out + (pair_ok, uplift)
    return tuple(_to_device(a, device) for a in out)


def _lb_tables(instances, dims: _FleetDims, device) -> tuple:
    """The stage-1 tables of ``_build_lb_arrays`` packed once a fleet
    (:func:`repro_torch.kernels.cpm.pack_lb_tables`, on the host) and
    placed on ``device``: ``(PackedLB,)``, what ``_fleet_lb_device`` takes
    on any device (the CPU route unpacks it once)."""
    return (kcpm.pack_lb_tables(*_build_lb_arrays(instances, dims, "cpu")).to(device),)


def _fleet_lb_device(
    racks,      # int16[B, n_pad] (the engine's rows: _FleetRows; int32 / int64 on the CPU)
    inst_id,    # int32[B] (int64 beside int64 racks)
    *tables,    # the tables below (the plain version's) or their
                # kcpm.PackedLB (the engine's, made once a fleet by _lb_tables):
                # src, dst  int64[I, m_pad] edge tasks
                # p_src     f32[I, m_pad]  source-task duration per edge (0 on padding)
                # c_local   f32[I, m_pad]  local delay per edge (-inf on padding)
                # c_net     f32[I, m_pad]  optimistic network duration (-inf on padding)
                # net_work  f32[I, m_pad]  min network duration (0 on padding)
                # p_task    f32[I, n_pad]  task durations (0 on padding)
                # chan_div  f32[I]         1 + |K| network channels
                # pair_ok   f32[I, M_pad, M_pad] 1 = rack pair shares a reachable
                #           subchannel (omitted: no topology in fleet)
                # uplift    f32[I, m_pad]  forced-wired uplift q - min(q, q̌)
    M_pad: int,
    n_iters: int,
    block_b: int,
    contention: bool,
):
    """Batched combined §IV-A bound: one device program for the whole fleet.

    Builds the per-candidate max-plus adjacency (edge cost = p_u + r or
    p_u + min(q, q̌) depending on co-location), accumulates the contention
    terms and relaxes, all in one launch of the CUDA kernel
    :func:`repro_torch.kernels.cpm.fleet_combined_lb`, which reads int16
    racks, int32 instance ids and the packed tables; on the CPU its plain
    version :func:`repro_torch.kernels.ref.ref_fleet_lb` does the same in
    PyTorch and hands the adjacency to ``ref_combined_lb``.

    With ``pair_ok``/``uplift`` present, cross edges whose rack pair shares
    no reachable subchannel are charged the wired uplift through the
    kernel's matching-feasibility mask, and the contention side gains the
    serial forced-wired load term (all such edges traverse the single wired
    channel). Both terms stay admissible: any feasible schedule must pay
    ``q`` on forced edges.
    """
    global LB_TRACE_COUNT
    shapes = (racks,) + tuple(t.blob if isinstance(t, kcpm.PackedLB) else t for t in tables)
    key = _bucket_key(racks.device, shapes, (M_pad, n_iters, block_b, contention))
    if key not in _seen_stage1:
        _seen_stage1.add(key)
        LB_TRACE_COUNT += 1
    return kcpm.fleet_combined_lb(
        racks, inst_id, *tables, M_pad=M_pad, n_iters=n_iters, contention=contention,
    )


def batched_lower_bound(
    inst: ProblemInstance,
    racks: np.ndarray,
    use_kernel: bool = False,
    block_b: int = 1024,
    contention: bool = True,
    device=None,
) -> np.ndarray:
    """Combined §IV-A LB per assignment (critical path + contention terms).

    Critical path: dist[v] >= dist[u] + p_u + cost(u, v) where cost is r
    (same rack) or the optimistic network duration (different racks);
    converges in <= depth iterations. With ``contention=True`` (default)
    the result is maxed with the per-rack work and aggregate channel-work
    bounds of :mod:`repro_torch.core.bounds`, which is what makes dense
    instances prunable at all.

    With ``use_kernel=True`` the whole bound runs through the CUDA kernel
    path (`_fleet_lb_device` -> `repro_torch.kernels.cpm.fleet_combined_lb`)
    on dense size-bucketed adjacency blocks — the production stage-1 path
    of `vectorized_search` / `schedule_fleet`. The edge-list path is the
    portable reference oracle. Both run on ``device``.
    """
    dev = resolve_device(device)
    job = inst.job
    n, m = job.n_tasks, job.n_edges
    racks = np.asarray(racks, dtype=np.int32)
    B = racks.shape[0]

    if use_kernel:
        # LB-only dims: no op tables needed (only the n/m/M buckets and the
        # relaxation depth feed the bound program). The tables are packed
        # once for the call; the rows go through the engine's row buffer.
        dims = _fleet_dims([inst], use_wireless=True)
        B_pad = _bucket(B)
        rows = _FleetRows(B_pad, dims.n_pad, dev)
        rows.fill([(0, racks, n, 0)], dims.n_pad)
        out = _fleet_lb_device(
            rows.rack.to(dev, non_blocking=True),
            rows.iid.to(dev, non_blocking=True),
            *_lb_tables([inst], dims, dev),
            M_pad=dims.M_pad,
            n_iters=dims.n_iters,
            block_b=min(block_b, B_pad),
            contention=contention,
        )
        return rows.read([out])[:B].copy()

    if m == 0:
        base = np.broadcast_to(np.float32(np.max(job.p)), (B,)).astype(np.float32)
        if contention:
            extra = bounds_mod.contention_lower_bounds(inst, racks)
            base = np.maximum(base, extra.astype(np.float32))
        return base
    net = bounds_mod.min_network_durations(inst)

    p = _to_device(np.asarray(job.p, np.float32), dev)
    r = _to_device(np.asarray(inst.r_local, np.float32), dev)
    netc = _to_device(np.asarray(net, np.float32), dev)
    src = _to_device(job.edges[:, 0], dev)
    dst = _to_device(job.edges[:, 1], dev)
    topo = inst.topology
    conn = None if topo is None else torch.as_tensor(topo.pair_connected()).to(dev)
    q_wired = _to_device(np.asarray(inst.q_wired, np.float32), dev)

    rk = _to_device(racks, dev)
    if conn is None:
        netc_eff = netc
    else:
        # Forced-wired edges (rack pair shares no subchannel) pay q.
        netc_eff = torch.where(conn[rk[:, src], rk[:, dst]], netc, q_wired)
    cost = torch.where(rk[:, src] == rk[:, dst], r, netc_eff)
    dist = torch.zeros((B, n), dtype=torch.float32, device=dev)
    dst_b = dst.expand(B, m)
    for _ in range(n - 1):
        cand = dist[:, src] + p[src] + cost
        dist = torch.zeros_like(dist).scatter_reduce(
            1, dst_b, cand, "amax", include_self=True
        )
    out = (dist + p[None, :]).amax(dim=1).cpu().numpy()
    if contention:
        extra = bounds_mod.contention_lower_bounds(inst, racks)
        out = np.maximum(out, extra.astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# Search driver: lockstep fleet state machines + mega-batch launches
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VectorizedResult:
    """Outcome of one instance's vectorized search.

    Attributes:
      schedule: the winning assignment re-executed *exactly* by the host
        simulator (OP-checked; can only improve on the device score).
      makespan: ``schedule.makespan``.
      n_evaluated: candidates scored by the stage-2 greedy evaluator.
      best_assignment: int64[n_tasks] winning task->rack assignment.
      n_candidates: candidates considered (``n_evaluated + n_pruned``).
      n_pruned: candidates discarded by the stage-1 §IV-A bound.
      refine_rounds: refinement rounds actually run (sampled regime only).
      strategy_stats: per-strategy refinement counters keyed by strategy
        name (:class:`repro_torch.core.portfolio.StrategyStats`); all-zero when
        the instance was enumerated exhaustively or ``refine_rounds=0``.
    """

    schedule: Schedule
    makespan: float
    n_evaluated: int
    best_assignment: np.ndarray
    n_candidates: int = 0
    n_pruned: int = 0
    refine_rounds: int = 0
    strategy_stats: dict[str, portfolio_mod.StrategyStats] = dataclasses.field(
        default_factory=dict
    )


@dataclasses.dataclass
class FleetResult:
    """Outcome of one fleet mega-batch search.

    ``results[i]`` is bit-for-bit what ``vectorized_search(instances[i])``
    with the same parameters would return. Launch counters tell how many
    device dispatches the whole fleet cost; trace counters how many size
    buckets were used for the first time in the process (0 when a
    same-bucket fleet ran before, at most one per stage otherwise).

    Attributes:
      results: per-instance :class:`VectorizedResult`, in input order.
      makespans: float64[n_instances] of per-instance makespans.
      n_candidates / n_pruned / n_evaluated: fleet-total candidate counters
        (sums of the per-instance counters).
      n_stage1_launches / n_stage2_launches: device dispatches per stage.
      n_stage1_traces / n_stage2_traces: new size buckets per stage.
      strategy_stats: fleet-aggregated per-strategy refinement counters
        (counter sums; ``weight`` is the mean final allocator weight).
    """

    results: list[VectorizedResult]
    makespans: np.ndarray
    n_candidates: int
    n_pruned: int
    n_evaluated: int
    n_stage1_launches: int
    n_stage2_launches: int
    n_stage1_traces: int
    n_stage2_traces: int
    strategy_stats: dict[str, portfolio_mod.StrategyStats] = dataclasses.field(
        default_factory=dict
    )


# The refinement mutation kernel now lives in repro_torch.core.portfolio (it is
# the "mutation" portfolio strategy); kept aliased for callers of the old
# private name.
_mutate_pool = portfolio_mod.mutate_pool


class _InstanceState:
    """Per-instance search state machine.

    Mirrors the single-instance candidate flow exactly — chunking, buffered
    stage-1 pruning against the running incumbent, fixed-size stage-2
    flushes, strict-improvement incumbent updates — while the fleet driver
    advances all states in lockstep and batches their device work into
    shared launches. Because each state's decisions depend only on its own
    rows (and per-row device results are padding-invariant), fleet results
    equal single-instance results bit for bit.
    """

    def __init__(
        self,
        idx: int,
        inst: ProblemInstance,
        *,
        seed: int,
        max_enumerate: int,
        n_samples: int,
        batch_size: int,
        strategies=None,
        refine_pool: int = 1024,
        patience: int = 1,
        seed_pool: np.ndarray | None = None,
    ):
        self.idx = idx
        self.inst = inst
        self.n = inst.job.n_tasks
        self.batch_size = batch_size
        M = inst.n_racks
        # Bell-number guard: enumerate if the canonical count fits the budget.
        cands = enumerate_assignments(self.n, M, limit=max_enumerate + 1)
        self.sampled = cands.shape[0] > max_enumerate
        if self.sampled:
            rng = np.random.default_rng(seed)
            # Warm-start seed pool: known-good assignments (e.g. incumbents
            # of a previous solve of the same job) lead the sweep so the
            # incumbent — and with it stage-1 pruning — is strong from the
            # first block. Budget-neutral: each seed row displaces one
            # random sample, so warm and cold runs consider the same
            # number of candidates (the random rows are drawn identically
            # and truncated, keeping the RNG stream comparable).
            random_rows = sample_assignments(rng, self.n, M, n_samples)
            parts = [
                enumerate_assignments(self.n, min(2, M), limit=n_samples),
                random_rows,
            ]
            if seed_pool is not None and len(seed_pool):
                seeds = np.asarray(seed_pool, dtype=np.int32).reshape(-1, self.n)
                seeds = (seeds % M)[:n_samples].astype(np.int32)
                parts = [seeds] + parts[:1] + [random_rows[: n_samples - seeds.shape[0]]]
            cands = np.concatenate(parts, axis=0)
        self.cands = cands
        self.pos = 0
        self.buffer: list[np.ndarray] = []
        self.tag_buffer: list[np.ndarray] = []
        self.buffered = 0
        self.best_val = np.inf
        self.best_rack: np.ndarray | None = None
        self.n_eval = 0
        self.n_pruned = 0
        self.n_cands = 0
        self.rng_refine = np.random.default_rng(seed + 1)
        self.refine_rounds_run = 0
        self.prev_best = np.inf
        self.patience = patience
        self.stall = 0
        self.portfolio = portfolio_mod.Portfolio(
            portfolio_mod.build_strategies(strategies),
            inst,
            self.rng_refine,
            pool_size=refine_pool,
        )

    def next_chunk(self) -> np.ndarray | None:
        if self.pos >= self.cands.shape[0]:
            return None
        chunk = self.cands[self.pos : self.pos + self.batch_size]
        self.pos += self.batch_size
        return chunk

    def consider(self, chunk: np.ndarray, lbs: np.ndarray | None, tags=None):
        """Prune a chunk against the incumbent, buffer survivors, emit any
        full stage-2 blocks. ``tags`` are per-row portfolio strategy ids
        (-1 = untagged sweep candidates) threaded through buffering so
        scores can be credited back. Returns [(state, block, true_b, tags)].
        """
        self.n_cands += chunk.shape[0]
        if tags is None:
            tags = np.full(chunk.shape[0], -1, dtype=np.int32)
        if lbs is not None:
            keep = lbs < self.best_val - 1e-6
            self.n_pruned += int((~keep).sum())
            self.portfolio.note_pruned(tags[~keep])
            chunk = chunk[keep]
            tags = tags[keep]
        if chunk.shape[0]:
            self.buffer.append(chunk)
            self.tag_buffer.append(tags)
            self.buffered += chunk.shape[0]
        return self._emit_full()

    def _cat_buffer(self):
        pool = (
            np.concatenate(self.buffer, axis=0)
            if len(self.buffer) > 1
            else self.buffer[0]
        )
        tags = (
            np.concatenate(self.tag_buffer, axis=0)
            if len(self.tag_buffer) > 1
            else self.tag_buffer[0]
        )
        return pool, tags

    def _emit_full(self):
        if self.buffered < self.batch_size:
            return []
        pool, tags = self._cat_buffer()
        bs = self.batch_size
        n_full = (pool.shape[0] // bs) * bs
        blocks = [
            (self, pool[i : i + bs], bs, tags[i : i + bs])
            for i in range(0, n_full, bs)
        ]
        tail, tail_tags = pool[n_full:], tags[n_full:]
        self.buffer = [tail] if tail.shape[0] else []
        self.tag_buffer = [tail_tags] if tail.shape[0] else []
        self.buffered = tail.shape[0]
        return blocks

    def flush_partial(self):
        """Emit everything still buffered (tail padded to the block size;
        pad-row scores are discarded on apply)."""
        blocks = self._emit_full()
        if self.buffered:
            tail, tail_tags = self._cat_buffer()
            true_b = tail.shape[0]
            block = np.concatenate(
                [tail, np.tile(tail[:1], (self.batch_size - true_b, 1))], axis=0
            )
            blocks.append((self, block, true_b, tail_tags))
            self.buffer = []
            self.tag_buffer = []
            self.buffered = 0
        return blocks

    def apply_scores(self, block: np.ndarray, vals: np.ndarray, tags) -> None:
        """Strict-improvement incumbent update over one block's true rows,
        then feed the scored rows back to the portfolio (elite pool plus
        per-strategy credit for tagged refinement rows)."""
        self.n_eval += vals.shape[0]
        prev_best = self.best_val
        j = int(np.argmin(vals))
        if vals[j] < self.best_val:
            self.best_val = float(vals[j])
            self.best_rack = block[j].astype(np.int64)
        self.portfolio.observe(tags, block[: vals.shape[0]], vals, prev_best)


def _run_fleet(
    instances: list[ProblemInstance],
    *,
    max_enumerate: int,
    n_samples: int,
    seeds: list[int],
    use_wireless: bool,
    batch_size: int,
    lb_prune: bool,
    use_kernel: bool,
    contention: bool,
    refine_rounds: int,
    refine_pool: int,
    strategies=None,
    refine_patience: int | None = None,
    seed_pools=None,
    op_tables=None,
    tracer=None,
    device=None,
):
    """Lockstep fleet driver: one mega-batch launch geometry per stage.

    Every stage-1 and stage-2 launch is ``[I * batch_size]`` rows on one
    device, so the whole fleet run uses (at most) one size bucket per stage
    no matter how pruning fragments the candidate streams. Tables move to
    ``device`` once per fleet.

    ``tracer`` (a :class:`repro_torch.obs.trace.Tracer` or ``None``) records a
    wall-time span per stage-1/stage-2 device dispatch, the fleet's
    candidate/prune/launch/retrace totals as a ``fleet_solve`` event, and
    the per-strategy refinement yields as a ``portfolio_yields`` event.
    """
    tr = as_tracer(tracer)
    I = len(instances)
    if op_tables is None:
        op_tables = [build_op_tables(inst) for inst in instances]
    dims = _fleet_dims(instances, use_wireless, op_tables)
    dev = resolve_device(device)
    devs = _stage2_devices(dev)
    n_dev = len(devs)
    eval_tables = _stage2_tables(
        _build_eval_stack(instances, dims, use_wireless, "cpu", op_tables), devs)
    lb_tables = _lb_tables(instances, dims, dev) if use_kernel else None
    t2_0, t1_0 = TRACE_COUNT, LB_TRACE_COUNT
    launches = [0, 0]  # [stage1, stage2]

    # Stage 2's rows split evenly over the local cards (the reference's
    # shard_map): B2 rounds up to a multiple of the card count. Both stages
    # write their rows into one pinned buffer, reused launch after launch:
    # each launch reads its results back (waiting for every card) before
    # the next one writes, so the copies out of it are done by then.
    B1 = I * batch_size
    B2 = I * batch_size
    if B2 % n_dev:
        B2 += n_dev - B2 % n_dev
    rows = _FleetRows(B2, dims.n_pad, dev)

    # Patience default: stop at the first non-improving round (the
    # pre-portfolio rule) for a single strategy; give multi-strategy
    # portfolios a few stalled rounds so annealing can tunnel.
    if refine_patience is None:
        refine_patience = 1 if portfolio_mod.spec_length(strategies) == 1 else 3
    if seed_pools is None:
        seed_pools = [None] * I
    states = [
        _InstanceState(
            i,
            inst,
            seed=seeds[i],
            max_enumerate=max_enumerate,
            n_samples=n_samples,
            batch_size=batch_size,
            strategies=strategies,
            refine_pool=refine_pool,
            patience=refine_patience,
            seed_pool=seed_pools[i],
        )
        for i, inst in enumerate(instances)
    ]

    def launch_stage2(blocks) -> None:
        # blocks: [(state, block[batch_size, state.n], true_b, tags)],
        # applied in order so per-state incumbent evolution matches the
        # solo flow.
        for g0 in range(0, len(blocks), I):
            group = blocks[g0 : g0 + I]
            rows.fill([(s * batch_size, blk, st.n, st.idx)
                       for s, (st, blk, _tb, _tg) in enumerate(group)], dims.n_pad)
            with tr.span("stage2_launch", rows=B2):
                parts = _stage2_split(rows.rack, rows.iid, eval_tables, devs, dims)
                vals = rows.read(parts)
            launches[1] += 1
            for s, (st, blk, tb, tg) in enumerate(group):
                lo = s * batch_size
                st.apply_scores(blk, vals[lo : lo + tb], tg)

    def launch_stage1(reqs):
        # reqs: [(state, chunk)] -> per-request float32 LB arrays.
        if not reqs:
            return []
        if not use_kernel:
            launches[0] += len(reqs)
            with tr.span("stage1_launch", n_requests=len(reqs), kernel=False):
                return [
                    batched_lower_bound(
                        st.inst, chunk, use_kernel=False, contention=contention,
                        device=dev,
                    )
                    for st, chunk in reqs
                ]
        out = [np.empty(chunk.shape[0], np.float32) for _, chunk in reqs]
        pieces = []
        for ri, (_st, chunk) in enumerate(reqs):
            for off in range(0, chunk.shape[0], batch_size):
                pieces.append((ri, off, chunk[off : off + batch_size]))
        for g0 in range(0, len(pieces), I):
            group = pieces[g0 : g0 + I]
            # A piece's instance id covers its whole batch_size block.
            rows.fill([(s * batch_size, cands, reqs[ri][0].n, reqs[ri][0].idx)
                       for s, (ri, _off, cands) in enumerate(group)], dims.n_pad,
                      span=batch_size)
            with tr.span("stage1_launch", rows=B1, kernel=True):
                lbs = rows.read([_fleet_lb_device(
                    rows.rack[:B1].to(dev, non_blocking=True),
                    rows.iid[:B1].to(dev, non_blocking=True),
                    *lb_tables,
                    M_pad=dims.M_pad,
                    n_iters=dims.n_iters,
                    block_b=min(1024, B1),
                    contention=contention,
                )])
            launches[0] += 1
            for s, (ri, off, cands) in enumerate(group):
                lo = s * batch_size
                out[ri][off : off + cands.shape[0]] = lbs[lo : lo + cands.shape[0]]
        return out

    def prune_and_score(round_chunks) -> None:
        prune_reqs = [
            (st, chunk)
            for st, chunk in round_chunks
            if lb_prune and np.isfinite(st.best_val)
        ]
        lbs_list = launch_stage1(prune_reqs)
        lbs_by_state = {
            id(st): lbs for (st, _), lbs in zip(prune_reqs, lbs_list)
        }
        blocks = []
        for st, chunk in round_chunks:
            blocks += st.consider(chunk, lbs_by_state.get(id(st)))
        launch_stage2(blocks)

    # Main sweep: one chunk per instance per lockstep round.
    while any(st.pos < st.cands.shape[0] for st in states):
        round_chunks = []
        for st in states:
            chunk = st.next_chunk()
            if chunk is not None:
                round_chunks.append((st, chunk))
        prune_and_score(round_chunks)
    blocks = []
    for st in states:
        blocks += st.flush_partial()
    launch_stage2(blocks)
    for st in states:
        assert st.best_rack is not None

    # Refinement: the lockstep strategy portfolio for sampled-regime
    # instances. Each round every active instance's portfolio proposes one
    # tagged candidate pool (budget split across strategies by recent
    # yield); proposals ride the shared stage-1/stage-2 launches exactly
    # like sweep candidates. An instance stops independently after
    # ``patience`` consecutive non-improving rounds.
    active = [st for st in states if st.sampled] if refine_rounds > 0 else []
    for _ in range(refine_rounds):
        if not active:
            break
        round_chunks = []
        for st in active:
            st.prev_best = st.best_val
            pool, tags = st.portfolio.begin_round(st.best_rack, st.best_val)
            round_chunks.append((st, pool, tags))
        prune_reqs = [
            (st, chunk)
            for st, chunk, _tags in round_chunks
            if lb_prune and np.isfinite(st.best_val) and chunk.shape[0]
        ]
        lbs_list = launch_stage1(prune_reqs)
        lbs_by_state = {id(st): lbs for (st, _), lbs in zip(prune_reqs, lbs_list)}
        blocks = []
        for st, chunk, tags in round_chunks:
            blocks += st.consider(chunk, lbs_by_state.get(id(st)), tags=tags)
            blocks += st.flush_partial()
        launch_stage2(blocks)
        nxt = []
        for st in active:
            st.portfolio.end_round(st.best_rack, st.best_val)
            st.refine_rounds_run += 1
            if st.best_val < st.prev_best - 1e-9:
                st.stall = 0
            else:
                st.stall += 1
            if st.stall < st.patience:
                nxt.append(st)
        active = nxt

    results = []
    for st in states:
        sched = simulate(st.inst, st.best_rack, use_wireless=use_wireless)
        results.append(
            VectorizedResult(
                schedule=sched,
                makespan=sched.makespan,
                n_evaluated=st.n_eval,
                best_assignment=st.best_rack,
                n_candidates=st.n_cands,
                n_pruned=st.n_pruned,
                refine_rounds=st.refine_rounds_run,
                strategy_stats=st.portfolio.stats,
            )
        )
    stats = {
        "n_stage1_launches": launches[0],
        "n_stage2_launches": launches[1],
        "n_stage1_traces": LB_TRACE_COUNT - t1_0,
        "n_stage2_traces": TRACE_COUNT - t2_0,
    }
    if tr.enabled:
        tr.count("stage1_launches", launches[0])
        tr.count("stage2_launches", launches[1])
        tr.count(
            "compile_cache_misses",
            stats["n_stage1_traces"] + stats["n_stage2_traces"],
        )
        tr.event(
            "fleet_solve",
            n_instances=I,
            n_candidates=sum(s.n_cands for s in states),
            n_pruned=sum(s.n_pruned for s in states),
            n_evaluated=sum(s.n_eval for s in states),
            **stats,
        )
        merged = portfolio_mod.merge_strategy_stats(
            s.portfolio.stats for s in states
        )
        if merged:
            tr.event(
                "portfolio_yields",
                strategies=portfolio_mod.stats_snapshot(merged),
            )
    return results, stats


def vectorized_search(
    inst: ProblemInstance,
    max_enumerate: int = 200_000,
    n_samples: int = 8192,
    seed: int = 0,
    use_wireless: bool = True,
    batch_size: int = 8192,
    lb_prune: bool = True,
    use_kernel: bool = True,
    refine_rounds: int = 4,
    refine_pool: int = 1024,
    contention: bool = True,
    strategies=None,
    refine_patience: int | None = None,
    seed_pool: np.ndarray | None = None,
    tracer=None,
    device=None,
) -> VectorizedResult:
    """Best-of-batch schedule search with bound-driven pruning.

    Enumerates all canonical assignments when that is small enough, else
    samples. Each batch first passes through the combined §IV-A bound
    kernel (stage 1); only candidates whose bound beats the incumbent are
    scheduled by the batched greedy evaluator (stage 2). In the sampled
    regime the incumbent is refined by the strategy portfolio of
    :mod:`repro_torch.core.portfolio`. The winner is re-executed with the exact
    host simulator (which can only improve on the vectorized non-delay
    score) and verified. The fleet-of-one special case of
    :func:`schedule_fleet`.

    Args:
      inst: the problem instance.
      max_enumerate: enumerate exhaustively iff the canonical assignment
        count (restricted growth strings) is at most this; else sample.
      n_samples: random candidates in the sampled regime (plus a 2-rack
        canonical prefix of the same size).
      seed: master seed. Sampling uses ``default_rng(seed)``; refinement
        draws from ``default_rng(seed + 1)``. Fixed seed + fixed
        parameters => bit-identical results across runs and across fleet
        packings (device scores are float32-deterministic on one backend).
      use_wireless: expose the instance's wireless subchannels to the
        evaluator (``False`` models wired-only operation).
      batch_size: stage-2 block size; candidate streams are chunked,
        pruned, and re-blocked to exactly this many rows per launch.
      lb_prune: enable stage-1 pruning (exact w.r.t. the greedy objective:
        ``LB(c) >= incumbent`` implies c cannot improve the incumbent).
      use_kernel: stage-1 via the fused CUDA bound kernel (else the
        portable edge-list oracle).
      refine_rounds: max refinement rounds (sampled regime only).
      refine_pool: per-round refinement candidate budget, split across the
        portfolio's strategies by recent yield.
      contention: include the §IV-A contention terms (per-rack work +
        aggregate channel work) in the stage-1 bound.
      strategies: refinement portfolio spec for
        :func:`repro_torch.core.portfolio.build_strategies`. ``None`` (default)
        is mutation-only local search — bit-for-bit the pre-portfolio
        refinement loop; ``"portfolio"`` enables
        mutation + elite crossover + simulated annealing under the
        multiplicative-weights budget allocator.
      refine_patience: stop refining after this many consecutive
        non-improving rounds. ``None`` => 1 for a single strategy (the
        pre-portfolio rule), 3 for a multi-strategy portfolio.
      seed_pool: optional int[S, n_tasks] warm-start assignments (e.g.
        incumbents from a previous solve of the same job) injected at the
        head of the sampled-regime sweep. Budget-neutral: each seed
        displaces one random sample, so ``n_candidates`` is unchanged.
        Labels are folded into ``[0, n_racks)`` with a modulo, letting
        incumbents from a differently-sized resource view seed a residual
        re-solve. Ignored in the exhaustive-enumeration regime (the sweep
        already covers every canonical assignment). Scored seeds enter
        the refinement portfolio's elite pool like any sweep candidate,
        so crossover can recombine them from round one.
      tracer: optional :class:`repro_torch.obs.trace.Tracer` recording
        per-stage device-dispatch spans and the solve's candidate /
        prune / retrace totals (``None`` = no tracing; bit-identical).
      device: ``None`` (the CUDA card) or ``"cpu"``; see
        :func:`repro_torch.device.resolve_device`.

    Returns:
      :class:`VectorizedResult` (per-strategy refinement counters in
      ``strategy_stats``).
    """
    dev = resolve_device(device)
    tr = as_tracer(tracer)
    with tr.span("schedule_fleet", n_instances=1):
        results, _ = _run_fleet(
            [inst],
            max_enumerate=max_enumerate,
            n_samples=n_samples,
            seeds=[seed],
            use_wireless=use_wireless,
            batch_size=batch_size,
            lb_prune=lb_prune,
            use_kernel=use_kernel,
            contention=contention,
            refine_rounds=refine_rounds,
            refine_pool=refine_pool,
            strategies=strategies,
            refine_patience=refine_patience,
            seed_pools=[seed_pool],
            tracer=tr,
            device=dev,
        )
    return results[0]


def schedule_fleet(
    instances,
    max_enumerate: int = 200_000,
    n_samples: int = 8192,
    seed=0,
    use_wireless: bool = True,
    batch_size: int = 8192,
    lb_prune: bool = True,
    use_kernel: bool = True,
    refine_rounds: int = 4,
    refine_pool: int = 1024,
    contention: bool = True,
    strategies=None,
    refine_patience: int | None = None,
    seed_pools=None,
    op_tables=None,
    tracer=None,
    device=None,
) -> FleetResult:
    """Solve a heterogeneous fleet of instances in one padded mega-batch.

    All instances are padded to one shared size bucket and their candidate
    streams advance in lockstep: each round contributes one chunk per
    instance to a single stage-1 bound launch and the survivors to a single
    stage-2 evaluation launch, so the whole fleet uses at most one size
    bucket per stage and amortizes every dispatch across jobs.
    Refinement proposals (one tagged pool per instance per round, from that
    instance's private strategy portfolio) ride the same shared launches.

    Args:
      instances: iterable of :class:`ProblemInstance` (at least one).
      seed: scalar (shared by all instances) or one seed per instance.
      strategies: portfolio spec shared by all instances; each instance
        gets its own freshly built strategy objects, so pass registry
        names (e.g. ``"portfolio"`` or ``("mutation", "crossover")``) or
        zero-arg factories — live Strategy objects would alias state
        across the fleet and are rejected for fleets of more than one.
      seed_pools: ``None``, or one warm-start pool per instance (each
        ``None`` or int[S, n_tasks]; see ``seed_pool`` on
        :func:`vectorized_search`). The online serving layer uses this to
        re-optimize still-queued jobs from their incumbent assignments.
      op_tables: ``None``, or one prebuilt
        :class:`~repro_torch.core.simulator.OpTables` per instance. Tables
        depend only on ``inst.job``, so a caller that re-solves the same
        jobs across epochs (the online service) can build each job's
        tables once and skip the per-launch rebuild; passing ``None``
        builds them here. Results are bit-identical either way.
      tracer: optional :class:`repro_torch.obs.trace.Tracer`. Records a
        ``schedule_fleet`` span enclosing per-stage device-dispatch
        spans, plus ``fleet_solve`` (candidates / pruned / launches /
        retraces) and ``portfolio_yields`` decision events. ``None``
        (default) traces nothing and is bit-identical.
      device: ``None`` (the CUDA card) or ``"cpu"``; without a card,
        ``None`` raises ``RuntimeError`` (no quiet CPU fallback).
      (remaining arguments: see :func:`vectorized_search`.)

    Determinism / solo equivalence: with the same seed and parameters,
    ``results[i]`` is bit-for-bit identical to
    ``vectorized_search(instances[i], ...)`` run alone — fleet packing
    never changes any per-instance score, prune decision, or RNG draw.

    Returns:
      :class:`FleetResult` with per-instance results, fleet candidate /
      launch / trace counters, and fleet-aggregated ``strategy_stats``.
    """
    dev = resolve_device(device)
    instances = list(instances)
    if not instances:
        raise ValueError("schedule_fleet needs at least one instance")
    if len(instances) > 1 and strategies is not None and not isinstance(strategies, str):
        for item in strategies:
            if (
                not isinstance(item, (str, type))
                and hasattr(item, "propose")
            ):
                raise ValueError(
                    "fleets need per-instance strategy state: pass names or "
                    "factories, not live Strategy objects"
                )
    if np.ndim(seed) == 0:
        seeds = [int(seed)] * len(instances)
    else:
        seeds = [int(s) for s in seed]
        if len(seeds) != len(instances):
            raise ValueError("one seed per instance required")
    if seed_pools is not None and len(seed_pools) != len(instances):
        raise ValueError("one seed pool (or None) per instance required")
    if op_tables is not None and len(op_tables) != len(instances):
        raise ValueError("one OpTables per instance required")
    tr = as_tracer(tracer)
    with tr.span("schedule_fleet", n_instances=len(instances)):
        results, stats = _run_fleet(
            instances,
            max_enumerate=max_enumerate,
            n_samples=n_samples,
            seeds=seeds,
            use_wireless=use_wireless,
            batch_size=batch_size,
            lb_prune=lb_prune,
            use_kernel=use_kernel,
            contention=contention,
            refine_rounds=refine_rounds,
            refine_pool=refine_pool,
            strategies=strategies,
            refine_patience=refine_patience,
            seed_pools=seed_pools,
            op_tables=op_tables,
            tracer=tr,
            device=dev,
        )
    return FleetResult(
        results=results,
        makespans=np.asarray([r.makespan for r in results]),
        n_candidates=sum(r.n_candidates for r in results),
        n_pruned=sum(r.n_pruned for r in results),
        n_evaluated=sum(r.n_evaluated for r in results),
        strategy_stats=portfolio_mod.merge_strategy_stats(
            r.strategy_stats for r in results
        ),
        **stats,
    )
