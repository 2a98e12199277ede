# Ported from src/repro/core/bnb.py; imports retargeted to repro_torch.
"""Combinatorial Branch-and-Bound for the joint scheduling problem.

The paper solves RP with an LP-based B&B (Gurobi). Big-M disjunctive models
have notoriously weak LP relaxations, so as a *beyond-paper* exact method we
also implement a two-level combinatorial B&B that exploits the problem
structure directly while reusing the paper's §IV-A bounds:

  Level 1 — DFS over task->rack assignments in topological order with rack
            symmetry breaking (a task may open at most one fresh rack).
            Pruned by a partial-assignment lower bound: critical path with
            optimistic transfer costs, per-rack loads, and aggregate channel
            work; seeded with the single-rack incumbent that attains the
            paper's T_max and with contention-aware greedy schedules.
  Level 2 — at complete assignments, channels and sequencing are solved
            exactly by Giffler–Thompson active-schedule enumeration over a
            flexible job shop: task operations are fixed to their rack
            machine; cross-rack transfer operations are flexible over
            {wired b} ∪ K wireless channels; local transfers are folded into
            ready times (the infinite-capacity virtual channel c of §IV-B).
            Identical channels are canonicalized (only one of each distinct
            availability time is branched) and states are pruned through a
            Pareto transposition table keyed by the scheduled-operation set.

For a regular objective (makespan) the set of active schedules contains an
optimal schedule, so enumeration of active schedules plus exact assignment
enumeration yields the OP optimum. Cross-validated against the RP/HiGHS
solver on small instances by the test suite.

The hot path is deliberately numpy-free: at these instance sizes (|V| <= ~12,
|E| <= ~30) Python lists are ~10x faster than numpy scalar indexing.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import bounds as bounds_mod
from repro_torch.core.instance import CH_LOCAL, CH_WIRED, ProblemInstance
from repro_torch.core.schedule import Schedule, check_feasible
from repro_torch.core.simulator import simulate

__all__ = ["BnbResult", "solve_bnb"]

_INF = float("inf")


@dataclasses.dataclass
class BnbResult:
    schedule: Schedule
    makespan: float
    nodes_assignment: int
    nodes_sequencing: int
    wall_s: float
    proved_optimal: bool


class _GT:
    """Giffler–Thompson B&B over the fixed-assignment flexible job shop."""

    def __init__(self, inst: ProblemInstance, rack, ub: float, topo):
        job = inst.job
        self.inst = inst
        self.n = job.n_tasks
        self.n_racks = inst.n_racks
        self.n_chan = 1 + inst.n_wireless  # pooled: 0 = wired, 1.. = wireless
        self.p = [float(x) for x in job.p]
        self.rack = [int(x) for x in rack]
        self.topo = [int(v) for v in topo]
        q = inst.q_wired
        qw = inst.q_wireless
        r = inst.r_local
        src = job.edges[:, 0]
        dst = job.edges[:, 1]

        # Split edges into cross (network) and local (folded into readiness).
        self.cross: list[int] = []      # original edge ids
        self.cq: list[float] = []       # wired duration per cross edge
        self.cqw: list[float] = []      # wireless duration per cross edge
        self.csrc: list[int] = []
        self.cdst: list[int] = []
        in_local: list[list[tuple[int, float]]] = [[] for _ in range(self.n)]
        in_cross: list[list[int]] = [[] for _ in range(self.n)]
        for e in range(job.n_edges):
            u, v = int(src[e]), int(dst[e])
            if self.rack[u] != self.rack[v]:
                ci = len(self.cross)
                self.cross.append(e)
                self.cq.append(float(q[e]))
                self.cqw.append(float(qw[e]))
                self.csrc.append(u)
                self.cdst.append(v)
                in_cross[v].append(ci)
            else:
                in_local[v].append((u, float(r[e])))
        self.in_local = in_local
        self.in_cross = in_cross
        self.nc = len(self.cross)
        # All channels truly identical? (paper's experiments: B == B_s)
        self.pooled = all(
            abs(a - b) < 1e-12 for a, b in zip(self.cq, self.cqw)
        ) or inst.n_wireless == 0

        # Optimistic tails: tail[v] = p_v + max downstream path.
        cmin = [
            min(self.cq[i], self.cqw[i]) if inst.n_wireless else self.cq[i]
            for i in range(self.nc)
        ]
        self.cmin = cmin
        tail = list(self.p)
        out_local: list[list[tuple[int, float]]] = [[] for _ in range(self.n)]
        out_cross: list[list[int]] = [[] for _ in range(self.n)]
        for v in range(self.n):
            for (u, rr) in in_local[v]:
                out_local[u].append((v, rr))
            for ci in in_cross[v]:
                out_cross[self.csrc[ci]].append(ci)
        for v in reversed(self.topo):
            best = 0.0
            for (w, rr) in out_local[v]:
                c = rr + tail[w]
                if c > best:
                    best = c
            for ci in out_cross[v]:
                c = cmin[ci] + tail[self.cdst[ci]]
                if c > best:
                    best = c
            tail[v] = self.p[v] + best
        self.tail = tail
        self.out_cross = out_cross

        self.best_ub = float(ub)
        self.best: tuple[list, list, list] | None = None
        self.nodes = 0
        self.deadline: float | None = None
        self.proved = True
        # Pareto transposition table: scheduled-set bitmask -> state tuples.
        self.tt: dict[int, list[tuple]] = {}
        self.tt_cap = 64

    def solve(self, time_limit: float | None = None):
        self.deadline = (
            time.perf_counter() + time_limit if time_limit is not None else None
        )
        self._dfs(
            [-1.0] * self.n,
            [-1.0] * self.nc,
            [-1] * self.nc,
            [0.0] * self.n_racks,
            [0.0] * self.n_chan,
        )
        return self.best, self.best_ub, self.nodes, self.proved

    # ------------------------------------------------------------------
    def _quick_lb(self, sstart, tstart, tchan) -> float:
        """LB: resource-relaxed critical path + rack and channel bounds."""
        p, tail = self.p, self.tail
        est = [0.0] * self.n
        lb = 0.0
        for v in self.topo:
            sv = sstart[v]
            if sv >= 0.0:
                t = sv
            else:
                t = 0.0
                for (u, rr) in self.in_local[v]:
                    c = est[u] + p[u] + rr
                    if c > t:
                        t = c
                for ci in self.in_cross[v]:
                    ts = tstart[ci]
                    if ts >= 0.0:
                        d = self.cq[ci] if tchan[ci] == 0 else self.cqw[ci]
                        c = ts + d
                    else:
                        u = self.csrc[ci]
                        c = est[u] + p[u] + self.cmin[ci]
                    if c > t:
                        t = c
            est[v] = t
            c = t + tail[v]
            if c > lb:
                lb = c

        # Rack head+work+tail bounds over unscheduled tasks.
        head = [_INF] * self.n_racks
        work = [0.0] * self.n_racks
        tl = [_INF] * self.n_racks
        any_work = False
        for v in range(self.n):
            if sstart[v] < 0.0:
                i = self.rack[v]
                if est[v] < head[i]:
                    head[i] = est[v]
                work[i] += p[v]
                t2 = tail[v] - p[v]
                if t2 < tl[i]:
                    tl[i] = t2
                any_work = True
        if any_work:
            for i in range(self.n_racks):
                if work[i] > 0.0:
                    c = head[i] + work[i] + tl[i]
                    if c > lb:
                        lb = c

        # Aggregate channel bound over unscheduled cross transfers.
        h, w, t2 = _INF, 0.0, _INF
        for ci in range(self.nc):
            if tstart[ci] < 0.0:
                u = self.csrc[ci]
                c = est[u] + p[u]
                if c < h:
                    h = c
                w += self.cmin[ci]
                tt = tail[self.cdst[ci]]
                if tt < t2:
                    t2 = tt
        if w > 0.0:
            c = h + w / self.n_chan + t2
            if c > lb:
                lb = c
        return lb

    # ------------------------------------------------------------------
    def _dfs(self, sstart, tstart, tchan, rack_avail, chan_avail):
        if self.deadline is not None and time.perf_counter() > self.deadline:
            self.proved = False
            return
        self.nodes += 1
        p = self.p

        # Scheduled-set bitmask + dominance check.
        mask = 0
        for v in range(self.n):
            if sstart[v] >= 0.0:
                mask |= 1 << v
        for ci in range(self.nc):
            if tstart[ci] >= 0.0:
                mask |= 1 << (self.n + ci)
        fins = tuple(
            sstart[v] + p[v] if sstart[v] >= 0.0 else 0.0 for v in range(self.n)
        )
        if self.pooled:
            state = tuple(rack_avail) + tuple(sorted(chan_avail)) + fins
        else:
            state = (
                tuple(rack_avail)
                + (chan_avail[0],)
                + tuple(sorted(chan_avail[1:]))
                + fins
            )
        bucket = self.tt.get(mask)
        if bucket is not None:
            for vec in bucket:
                dominated = True
                for a, b in zip(vec, state):
                    if a > b + 1e-9:
                        dominated = False
                        break
                if dominated:
                    return
            keep = []
            for vec in bucket:
                dominates = True
                for a, b in zip(state, vec):
                    if a > b + 1e-9:
                        dominates = False
                        break
                if not dominates:
                    keep.append(vec)
            if len(keep) < self.tt_cap:
                keep.append(state)
            self.tt[mask] = keep
        else:
            self.tt[mask] = [state]

        # Completion: all tasks scheduled (transfers precede their dests).
        ntasks_done = 0
        for v in range(self.n):
            if sstart[v] >= 0.0:
                ntasks_done += 1
        if ntasks_done == self.n:
            mk = 0.0
            for v in range(self.n):
                c = sstart[v] + p[v]
                if c > mk:
                    mk = c
            if mk < self.best_ub - 1e-9:
                self.best_ub = mk
                self.best = (list(sstart), list(tstart), list(tchan))
            return

        # --- Candidates: (ect, est, kind, idx, machine) -------------------
        cands: list[tuple[float, float, int, int, int]] = []
        for v in range(self.n):
            if sstart[v] >= 0.0:
                continue
            ready = 0.0
            ok = True
            for (u, rr) in self.in_local[v]:
                if sstart[u] < 0.0:
                    ok = False
                    break
                c = sstart[u] + p[u] + rr
                if c > ready:
                    ready = c
            if not ok:
                continue
            for ci in self.in_cross[v]:
                if tstart[ci] < 0.0:
                    ok = False
                    break
                d = self.cq[ci] if tchan[ci] == 0 else self.cqw[ci]
                c = tstart[ci] + d
                if c > ready:
                    ready = c
            if not ok:
                continue
            i = self.rack[v]
            a = rack_avail[i]
            est = ready if ready > a else a
            cands.append((est + p[v], est, 0, v, i))
        for ci in range(self.nc):
            if tstart[ci] >= 0.0:
                continue
            u = self.csrc[ci]
            if sstart[u] < 0.0:
                continue
            ready = sstart[u] + p[u]
            if self.pooled:
                seen: set[float] = set()
                for c in range(self.n_chan):
                    a = chan_avail[c]
                    if a in seen:
                        continue
                    seen.add(a)
                    est = ready if ready > a else a
                    cands.append((est + self.cq[ci], est, 1, ci, c))
            else:
                a = chan_avail[0]
                est = ready if ready > a else a
                cands.append((est + self.cq[ci], est, 1, ci, 0))
                seen = set()
                for c in range(1, self.n_chan):
                    a = chan_avail[c]
                    if a in seen:
                        continue
                    seen.add(a)
                    est = ready if ready > a else a
                    cands.append((est + self.cqw[ci], est, 1, ci, c))

        if not cands:
            return  # dead end (cannot happen on a DAG)

        cands.sort()
        ect_star = cands[0][0]
        m_star = cands[0][4]
        conflict = [
            c for c in cands if c[4] == m_star and c[1] < ect_star - 1e-12
        ]
        # No-delay dominance: if the earliest-completing op finishes before
        # any competitor can start, branching on it alone is sufficient.
        if len(conflict) > 1:
            ect0 = conflict[0][0]
            if all(ect0 <= c[1] + 1e-12 for c in conflict[1:]):
                conflict = conflict[:1]

        for ect, est, kind, idx, mach in conflict:
            if kind == 0:
                v = idx
                sstart[v] = est
                old = rack_avail[mach]
                rack_avail[mach] = ect
                if self._quick_lb(sstart, tstart, tchan) < self.best_ub - 1e-9:
                    self._dfs(sstart, tstart, tchan, rack_avail, chan_avail)
                sstart[v] = -1.0
                rack_avail[mach] = old
            else:
                ci = idx
                tstart[ci] = est
                tchan[ci] = mach
                old = chan_avail[mach]
                chan_avail[mach] = ect
                if self._quick_lb(sstart, tstart, tchan) < self.best_ub - 1e-9:
                    self._dfs(sstart, tstart, tchan, rack_avail, chan_avail)
                tstart[ci] = -1.0
                tchan[ci] = -1
                chan_avail[mach] = old
            if self.deadline is not None and time.perf_counter() > self.deadline:
                self.proved = False
                return


# The level-1 partial-assignment bound lives in repro_torch.core.bounds so the
# B&B pruner, the vectorized stage-1 pruner, and the property tests all
# share one §IV-A implementation.
_assignment_lb = bounds_mod.partial_assignment_bound


def solve_fixed_assignment(
    inst: ProblemInstance,
    rack: np.ndarray,
    time_limit: float | None = None,
) -> BnbResult:
    """Exact channels + sequencing for a FIXED task->rack assignment (the
    Giffler–Thompson level alone). Used by distribution.plan where placement
    is dictated by the hardware, not optimized."""
    t0 = time.perf_counter()
    job = inst.job
    rack = np.asarray(rack, dtype=np.int64)
    topo = job.topo_order()
    heur = simulate(inst, rack, use_wireless=inst.n_wireless > 0)
    best_sched = heur
    gt = _GT(inst, rack, heur.makespan, topo)
    best, ub2, nodes, proved = gt.solve(time_limit=time_limit)
    if best is not None and ub2 < best_sched.makespan - 1e-9:
        sstart_l, tstart_l, tchan_l = best
        sstart = np.asarray(sstart_l)
        chan = np.zeros(job.n_edges, dtype=np.int64)
        ts = np.zeros(job.n_edges)
        for ci, e in enumerate(gt.cross):
            chan[e] = CH_WIRED if tchan_l[ci] == 0 else 1 + tchan_l[ci]
            ts[e] = tstart_l[ci]
        for e in range(job.n_edges):
            u, v = int(job.edges[e, 0]), int(job.edges[e, 1])
            if rack[u] == rack[v]:
                chan[e] = CH_LOCAL
                ts[e] = sstart[u] + float(job.p[u])
        best_sched = Schedule.build(inst, rack, sstart, chan, ts)
        check_feasible(inst, best_sched)
    return BnbResult(
        schedule=best_sched,
        makespan=best_sched.makespan,
        nodes_assignment=0,
        nodes_sequencing=nodes,
        wall_s=time.perf_counter() - t0,
        proved_optimal=proved,
    )


def solve_bnb(
    inst: ProblemInstance,
    time_limit: float | None = None,
    incumbent: Schedule | None = None,
    assignment_bound=None,
) -> BnbResult:
    """Exact two-level B&B. Returns the best (optimal unless timed out).

    ``assignment_bound`` is the level-1 bound hook: an optional callable
    ``(inst, rack_partial) -> float`` (rack_partial[v] = -1 when undecided)
    whose value is maxed with the built-in §IV-A partial-assignment bound
    (:func:`repro_torch.core.bounds.partial_assignment_bound`). It MUST be
    admissible — never exceed the best completion time reachable from the
    partial assignment — or optimality is lost. The vectorized fleet
    scheduler shares the same bound family through this module's
    ``_assignment_lb`` alias.
    """
    t0 = time.perf_counter()
    job = inst.job
    n = job.n_tasks
    topo = job.topo_order()
    min_cost = np.minimum(inst.r_local, inst.q_wired)
    if inst.n_wireless:
        min_cost = np.minimum(min_cost, inst.q_wireless)

    from repro_torch.core.baselines import g_list_schedule, single_rack_schedule

    best_sched = single_rack_schedule(inst)
    for cand in (
        g_list_schedule(inst, use_wireless=inst.n_wireless > 0),
        *([incumbent] if incumbent is not None else []),
    ):
        if cand.makespan < best_sched.makespan:
            best_sched = cand
    best_ub = best_sched.makespan

    nodes_a = 0
    nodes_s = 0
    proved = True
    deadline = t0 + time_limit if time_limit else None

    order = [int(v) for v in topo]
    rack = np.full(n, -1, dtype=np.int64)

    def dfs(pos: int, n_used: int):
        nonlocal nodes_a, nodes_s, best_ub, best_sched, proved
        if deadline is not None and time.perf_counter() > deadline:
            proved = False
            return
        nodes_a += 1
        lb = _assignment_lb(inst, rack, topo, min_cost)
        if assignment_bound is not None:
            # Copy: the DFS mutates this buffer after the frame returns, so
            # a hook that retains its argument must not see it rewritten.
            lb = max(lb, float(assignment_bound(inst, rack.copy())))
        if lb >= best_ub - 1e-9:
            return
        if pos == n:
            # Leaf-local heuristic incumbent before exact sequencing.
            # rack.copy(): the DFS buffer mutates after this frame returns.
            heur = simulate(
                inst, rack.copy(), use_wireless=inst.n_wireless > 0, check=False
            )
            if heur.makespan < best_ub - 1e-9:
                check_feasible(inst, heur)
                best_ub = heur.makespan
                best_sched = heur
            gt = _GT(inst, rack.copy(), best_ub, topo)
            remaining = None
            if deadline is not None:
                remaining = max(0.05, deadline - time.perf_counter())
            best, ub2, nn, pr = gt.solve(time_limit=remaining)
            nodes_s += nn
            proved = proved and pr
            if best is not None and ub2 < best_ub - 1e-9:
                sstart_l, tstart_l, tchan_l = best
                sstart = np.asarray(sstart_l)
                chan = np.zeros(job.n_edges, dtype=np.int64)
                ts = np.zeros(job.n_edges)
                for ci, e in enumerate(gt.cross):
                    # pooled channel 0 is wired; 1.. are wireless ids.
                    chan[e] = CH_WIRED if tchan_l[ci] == 0 else 1 + tchan_l[ci]
                    ts[e] = tstart_l[ci]
                for e in range(job.n_edges):
                    u, v = int(job.edges[e, 0]), int(job.edges[e, 1])
                    if rack[u] == rack[v]:
                        chan[e] = CH_LOCAL
                        ts[e] = sstart[u] + float(job.p[u])
                sched = Schedule.build(inst, rack.copy(), sstart, chan, ts)
                check_feasible(inst, sched)
                best_ub = sched.makespan
                best_sched = sched
            return
        v = order[pos]
        for i in range(min(n_used + 1, inst.n_racks)):
            rack[v] = i
            dfs(pos + 1, max(n_used, i + 1))
            rack[v] = -1
            if deadline is not None and time.perf_counter() > deadline:
                proved = False
                return

    dfs(0, 0)
    return BnbResult(
        schedule=best_sched,
        makespan=best_sched.makespan,
        nodes_assignment=nodes_a,
        nodes_sequencing=nodes_s,
        wall_s=time.perf_counter() - t0,
        proved_optimal=proved,
    )
