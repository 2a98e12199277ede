# Copied from src/repro/core/simulator.py; imports retargeted to repro_torch.
"""Discrete-event schedule executor (serial schedule generation with gap
insertion).

Given the two discrete decision vectors of the joint problem — task->rack and
edge->channel — this module derives start times greedily and returns a
complete, feasibility-checked :class:`Schedule`. It is the execution
substrate shared by all heuristic baselines, the vectorized solver's
incumbent generation, and the test oracle that re-executes MILP decisions.

Semantics follow OP exactly: racks are unary resources for computation,
channel ``b`` and each wireless subchannel are unary resources for transfers,
the virtual local channel ``c`` has infinite capacity, and an operation placed
into a timeline occupies a half-open interval [start, start+dur).
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.instance import CH_LOCAL, CH_WIRED, ProblemInstance
from repro_torch.core.schedule import Schedule

__all__ = [
    "simulate",
    "seed_channel_timelines",
    "critical_path_priority",
    "build_op_tables",
    "pad_op_tables",
    "OpTables",
    "PaddedOpTables",
    "AUTO_CHANNEL",
    "OP_TASK",
    "OP_EDGE",
    "OP_PAD",
]

AUTO_CHANNEL = -1

# Operation kinds in the static op table. OP_PAD marks no-op rows appended by
# consumers that pad the table to a fixed size bucket (the vectorized engine).
OP_TASK = 0
OP_EDGE = 1
OP_PAD = 2


@dataclasses.dataclass(frozen=True)
class OpTables:
    """Static, precedence-compatible operation tables for one instance.

    The shared substrate between the host simulator and the vectorized batch
    evaluator: both walk the same interleaved (edge*, task) sequence in
    topological order, and both resolve task readiness through the same
    padded in-edge table instead of scanning the edge list per event.

    Attributes:
      kind: int32[n_ops] OP_TASK / OP_EDGE rows, n_ops = n_tasks + n_edges.
      idx: int32[n_ops] task id for OP_TASK rows, edge id for OP_EDGE rows.
      edge_src / edge_dst: int32[n_edges] endpoints (copies of job.edges cols).
      task_in_edges: int32[n_tasks, max_indeg] edge ids entering each task,
        right-padded with -1 (max_indeg >= 1 always).
      task_out_edges: int32[n_tasks, max_outdeg] edge ids leaving each task,
        right-padded with -1 (max_outdeg >= 1 always).
    """

    kind: np.ndarray
    idx: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    task_in_edges: np.ndarray
    task_out_edges: np.ndarray

    @property
    def n_ops(self) -> int:
        return int(self.kind.shape[0])


def build_op_tables(inst: ProblemInstance) -> OpTables:
    """Build the static op tables for ``inst`` (topo order: in-edges, then task)."""
    job = inst.job
    n, m = job.n_tasks, job.n_edges
    in_lists: list[list[int]] = [[] for _ in range(n)]
    out_lists: list[list[int]] = [[] for _ in range(n)]
    for e in range(m):
        out_lists[int(job.edges[e, 0])].append(e)
        in_lists[int(job.edges[e, 1])].append(e)

    kind: list[int] = []
    idx: list[int] = []
    for v in job.topo_order():
        for e in in_lists[int(v)]:
            kind.append(OP_EDGE)
            idx.append(e)
        kind.append(OP_TASK)
        idx.append(int(v))

    def pad_table(lists: list[list[int]]) -> np.ndarray:
        width = max(1, max((len(l) for l in lists), default=0))
        out = np.full((n, width), -1, dtype=np.int32)
        for v, l in enumerate(lists):
            out[v, : len(l)] = l
        return out

    return OpTables(
        kind=np.asarray(kind, dtype=np.int32),
        idx=np.asarray(idx, dtype=np.int32),
        edge_src=job.edges[:, 0].astype(np.int32),
        edge_dst=job.edges[:, 1].astype(np.int32),
        task_in_edges=pad_table(in_lists),
        task_out_edges=pad_table(out_lists),
    )


@dataclasses.dataclass(frozen=True)
class PaddedOpTables:
    """Device-layout op tables padded to a caller-chosen size bucket.

    The SINGLE op-table layout shared by every batched evaluator: each row
    of the interleaved (edge*, task) sequence is flattened into parallel
    scalar columns so a ``lax.scan`` can walk it, and all columns are padded
    with OP_PAD no-op rows up to ``n_ops``. Instances of a heterogeneous
    fleet are padded to the SAME dims and stacked on a leading instance
    axis, so one compiled mega-batch program serves them all.

    Attributes:
      kind: int32[n_ops] OP_TASK / OP_EDGE / OP_PAD.
      op_task: int32[n_ops] task id on OP_TASK rows (0 otherwise).
      op_edge: int32[n_ops] edge id on OP_EDGE rows (0 otherwise).
      op_src / op_dst: int32[n_ops] edge endpoints on OP_EDGE rows.
      op_p: float32[n_ops] task duration on OP_TASK rows.
      op_wired / op_wireless / op_local: float32[n_ops] edge transfer
        durations on OP_EDGE rows (q, q̌, r of §II).
      op_in: int32[n_ops, indeg_pad] in-edge ids gating an OP_TASK row,
        right-padded with ``edge_sentinel`` (an always-zero slot the
        evaluator reserves past its edge-finish table).
    """

    kind: np.ndarray
    op_task: np.ndarray
    op_edge: np.ndarray
    op_src: np.ndarray
    op_dst: np.ndarray
    op_p: np.ndarray
    op_wired: np.ndarray
    op_wireless: np.ndarray
    op_local: np.ndarray
    op_in: np.ndarray


def pad_op_tables(
    inst: ProblemInstance,
    *,
    n_ops: int,
    indeg_pad: int,
    edge_sentinel: int,
    tables: OpTables | None = None,
) -> PaddedOpTables:
    """Pad ``build_op_tables(inst)`` into the flat device layout above.

    ``n_ops`` and ``indeg_pad`` must be at least the instance's true op
    count / max in-degree (callers pass the fleet-wide size bucket).
    ``tables`` lets callers that already built the instance's op tables
    (e.g. while sizing the fleet bucket) skip rebuilding them.
    """
    job = inst.job
    if tables is None:
        tables = build_op_tables(inst)
    if n_ops < tables.n_ops or indeg_pad < tables.task_in_edges.shape[1]:
        raise ValueError("padded dims smaller than the instance's op tables")

    kind = np.full(n_ops, OP_PAD, dtype=np.int32)
    op_task = np.zeros(n_ops, dtype=np.int32)
    op_edge = np.zeros(n_ops, dtype=np.int32)
    op_src = np.zeros(n_ops, dtype=np.int32)
    op_dst = np.zeros(n_ops, dtype=np.int32)
    op_p = np.zeros(n_ops, dtype=np.float32)
    op_wired = np.zeros(n_ops, dtype=np.float32)
    op_wireless = np.zeros(n_ops, dtype=np.float32)
    op_local = np.zeros(n_ops, dtype=np.float32)
    op_in = np.full((n_ops, indeg_pad), edge_sentinel, dtype=np.int32)

    q, qw, r = inst.q_wired, inst.q_wireless, inst.r_local
    for row in range(tables.n_ops):
        k, i = int(tables.kind[row]), int(tables.idx[row])
        kind[row] = k
        if k == OP_TASK:
            op_task[row] = i
            op_p[row] = job.p[i]
            ins = tables.task_in_edges[i]
            ins = ins[ins >= 0]
            op_in[row, : ins.size] = ins
        else:
            op_edge[row] = i
            op_src[row] = tables.edge_src[i]
            op_dst[row] = tables.edge_dst[i]
            op_wired[row] = q[i]
            op_wireless[row] = qw[i]
            op_local[row] = r[i]

    return PaddedOpTables(
        kind=kind,
        op_task=op_task,
        op_edge=op_edge,
        op_src=op_src,
        op_dst=op_dst,
        op_p=op_p,
        op_wired=op_wired,
        op_wireless=op_wireless,
        op_local=op_local,
        op_in=op_in,
    )


def seed_channel_timelines(
    chan_tl: dict, channel_busy: dict | None, *, strict: bool = True
) -> None:
    """Seed capacitated-channel timelines with pre-existing busy intervals.

    The single normalization point for the ``channel_busy`` replay hook
    (shared by :func:`simulate` and the busy-aware heuristic baselines):
    intervals are sorted and empty/inverted ones dropped. ``strict=True``
    rejects a channel id the caller's timeline set does not model;
    ``strict=False`` ignores it (a scheduler that never places transfers
    on that channel cannot conflict with it).
    """
    if not channel_busy:
        return
    for c, intervals in channel_busy.items():
        if c not in chan_tl:
            if strict:
                raise ValueError(
                    f"channel_busy for channel {c} not in this instance "
                    f"(capacitated channels: {sorted(chan_tl)})"
                )
            continue
        chan_tl[c].busy = sorted(
            (float(s), float(e)) for s, e in intervals if float(e) > float(s)
        )


class _Timeline:
    """Sorted busy intervals of a unary resource with gap search."""

    __slots__ = ("busy",)

    def __init__(self) -> None:
        self.busy: list[tuple[float, float]] = []

    def earliest_fit(self, ready: float, dur: float) -> float:
        t = ready
        for s, e in self.busy:
            if t + dur <= s:
                break
            if e > t:
                t = e
        return t

    def insert(self, start: float, dur: float) -> None:
        self.busy.append((start, start + dur))
        self.busy.sort()


def critical_path_priority(inst: ProblemInstance, pessimistic: bool = False) -> np.ndarray:
    """Task priority = longest downstream path (larger = more critical).

    ``pessimistic`` uses wired transfer times on edges (assume remote);
    otherwise local delays (assume co-located), matching Algorithm 1's cost.
    """
    job = inst.job
    cost = inst.q_wired if pessimistic else inst.r_local
    tail = job.p.astype(np.float64).copy()
    topo = job.topo_order()
    out_by_node: list[list[int]] = [[] for _ in range(job.n_tasks)]
    for e in range(job.n_edges):
        out_by_node[int(job.edges[e, 0])].append(e)
    for v in reversed(topo):
        best = 0.0
        for e in out_by_node[int(v)]:
            w = int(job.edges[e, 1])
            cand = cost[e] + tail[w]
            if cand > best:
                best = cand
        tail[int(v)] = job.p[int(v)] + best
    return tail


def simulate(
    inst: ProblemInstance,
    rack: np.ndarray,
    chan: np.ndarray | None = None,
    priority: np.ndarray | None = None,
    use_wireless: bool = True,
    check: bool = True,
    channel_busy: dict | None = None,
) -> Schedule:
    """Serial schedule generation.

    Args:
      rack: int[n_tasks] rack per task.
      chan: int[n_edges] channel per edge; entries may be AUTO_CHANNEL (-1) to
        let the simulator pick the earliest-finishing permitted channel at
        schedule time. Same-rack edges are always forced to CH_LOCAL, and
        cross-rack edges must not be CH_LOCAL. ``None`` = all AUTO.
      priority: float[n_tasks]; higher = scheduled earlier among ready ops.
        Defaults to critical-path priority.
      use_wireless: when False, AUTO channels may only pick the wired channel
        (the paper's wired-only baselines).
      check: run the OP feasibility checker on the result.
      channel_busy: optional offset-respecting replay hook — a mapping from
        channel id (CH_WIRED or 2+k) to pre-existing busy intervals
        ``[(start, end), ...]`` in this instance's time frame. Transfers are
        gap-inserted around them exactly like around the job's own transfers,
        so a schedule committed onto a shared cluster can be re-derived with
        cross-job channel offsets while keeping the rack and channel decision
        vectors fixed. Intervals may start before time 0 (a transfer of
        another job straddling the replay origin). With no busy intervals and
        a fixed ``chan`` equal to a previous run's resolved channels, the
        replay reproduces that run bit-for-bit.

    Returns a complete Schedule.
    """
    job = inst.job
    n, m = job.n_tasks, job.n_edges
    rack = np.asarray(rack, dtype=np.int64)
    if chan is None:
        chan_in = np.full(m, AUTO_CHANNEL, dtype=np.int64)
    else:
        chan_in = np.asarray(chan, dtype=np.int64).copy()
    if priority is None:
        priority = critical_path_priority(inst)

    dur_matrix = inst.durations_matrix()
    tables = build_op_tables(inst)
    # Reachability gating: with a restricted topology a cross-rack edge may
    # only use subchannels BOTH endpoint racks reach (None = all-ones mask,
    # the paper's model — the loop below is untouched).
    reach = None if inst.topology is None else inst.topology.reach

    # Resolve forced channels from locality.
    same = rack[job.edges[:, 0]] == rack[job.edges[:, 1]] if m else np.zeros(0, bool)
    for e in range(m):
        if same[e]:
            chan_in[e] = CH_LOCAL
        elif chan_in[e] == CH_LOCAL:
            raise ValueError(f"edge {e} is cross-rack but assigned local channel")

    rack_tl = [_Timeline() for _ in range(inst.n_racks)]
    chan_tl = {CH_WIRED: _Timeline()}
    for k in range(inst.n_wireless):
        chan_tl[2 + k] = _Timeline()
    seed_channel_timelines(chan_tl, channel_busy)

    start = np.full(n, -1.0)
    finish_task = np.full(n, np.inf)
    tstart = np.full(m, -1.0)
    finish_edge = np.full(m, np.inf)
    chan_out = chan_in.copy()

    # Dependency bookkeeping: task v waits on all in-edges; edge e waits on
    # its source task.
    n_wait_task = (tables.task_in_edges >= 0).sum(axis=1).astype(np.int64)

    # Ready heaps keyed by (-priority, index). Edge priority inherits the
    # priority of its destination task (it gates that task).
    ready: list[tuple[float, int, str, int]] = []
    seq = 0

    def push_task(v: int) -> None:
        nonlocal seq
        heapq.heappush(ready, (-float(priority[v]), seq, "T", v))
        seq += 1

    def push_edge(e: int) -> None:
        nonlocal seq
        v = int(job.edges[e, 1])
        heapq.heappush(ready, (-float(priority[v]), seq, "E", e))
        seq += 1

    for v in range(n):
        if n_wait_task[v] == 0:
            push_task(v)

    scheduled = 0
    total_ops = n + m
    while scheduled < total_ops:
        if not ready:
            raise RuntimeError("deadlock: no ready operations (cycle?)")
        _, _, kind, idx = heapq.heappop(ready)
        if kind == "T":
            v = idx
            ready_t = 0.0
            for e in tables.task_in_edges[v]:
                if e < 0:
                    break
                ready_t = max(ready_t, finish_edge[int(e)])
            tl = rack_tl[int(rack[v])]
            s = tl.earliest_fit(ready_t, float(job.p[v]))
            tl.insert(s, float(job.p[v]))
            start[v] = s
            finish_task[v] = s + float(job.p[v])
            # Out-edges become ready.
            for e in tables.task_out_edges[v]:
                if e < 0:
                    break
                push_edge(int(e))
            scheduled += 1
        else:
            e = idx
            u, v = int(job.edges[e, 0]), int(job.edges[e, 1])
            ready_t = finish_task[u]
            c = int(chan_out[e])
            if c == AUTO_CHANNEL:
                # Earliest-finish channel among permitted ones.
                cands = [CH_WIRED]
                if use_wireless:
                    if reach is None:
                        cands += [2 + k for k in range(inst.n_wireless)]
                    else:
                        ru, rv = int(rack[u]), int(rack[v])
                        cands += [
                            2 + k
                            for k in range(inst.n_wireless)
                            if reach[ru, k] and reach[rv, k]
                        ]
                best = None
                for cc in cands:
                    d = float(dur_matrix[e, cc])
                    s = chan_tl[cc].earliest_fit(ready_t, d)
                    key = (s + d, s, cc)
                    if best is None or key < best[0]:
                        best = (key, cc, s, d)
                assert best is not None
                _, c, s, d = best
                chan_out[e] = c
                chan_tl[c].insert(s, d)
            elif c == CH_LOCAL:
                d = float(dur_matrix[e, CH_LOCAL])
                s = ready_t
            else:
                if reach is not None and c >= 2:
                    ru, rv = int(rack[u]), int(rack[v])
                    if not (reach[ru, c - 2] and reach[rv, c - 2]):
                        raise ValueError(
                            f"edge {e} assigned subchannel {c - 2} "
                            f"unreachable from racks ({ru}, {rv})"
                        )
                d = float(dur_matrix[e, c])
                s = chan_tl[c].earliest_fit(ready_t, d)
                chan_tl[c].insert(s, d)
            tstart[e] = s
            finish_edge[e] = s + d
            n_wait_task[v] -= 1
            if n_wait_task[v] == 0:
                push_task(v)
            scheduled += 1

    sched = Schedule.build(inst, rack, start, chan_out, tstart)
    if check:
        from repro_torch.core.schedule import check_feasible

        check_feasible(inst, sched)
    return sched
