# Copied from src/repro/core/bounds.py; imports retargeted to repro_torch.
"""Heuristic bounds on the optimal job completion time (paper §IV-A).

Upper bound T_max: run the whole job on one rack in topological order; all
transfers are local. T_max = sum_v p_v + sum_e r_e.

Lower bound T_min: Algorithm 1 ("The Longest Branch Algorithm") — convert
node costs to out-edge costs c_(u,v) = p_u + r_(u,v), then longest path by
dynamic programming over a topological order; T_min = max_v dist(v) + p_v.

The paper's Algorithm 1 uses the LOCAL delay r as the per-edge transfer cost,
which is a valid lower bound whenever local transfer is never slower than a
network transfer (true in the paper's experiments where r = 0). ``safe=True``
instead uses min(r_e, q_e, q̌_e), which is a valid bound for arbitrary rates.

Assignment-conditional load bounds (§IV-A resource terms)
---------------------------------------------------------
Once a task->rack assignment x is fixed, two contention terms sharpen the
contention-free critical path (which several dense seeds cannot prune with
at all):

  * per-rack work   — racks are unary compute resources (constraint (5)),
    so makespan >= max_i Σ_{v: x_v = i} p_v
    (:func:`rack_load_bounds`; maps job.p onto the rack axis).
  * aggregate channel work — every cross-rack edge must occupy exactly one
    of the 1 + |K| network channels (wired ``b`` of rate B_s, constraint (8),
    plus the orthogonal wireless subchannels of rate B, constraint (9)) for
    at least min(q_(u,v), q̌_(u,v)) = d_(u,v) / max(B_s, B) time units, so
    makespan >= Σ_{(u,v): x_u != x_v} min(q, q̌) / (1 + |K|)
    (:func:`network_work_bounds`; maps job.d through q_wired / q_wireless).

Each term individually lower-bounds the optimal makespan for that
assignment AND the batched greedy evaluator's non-delay score, so
max(critical_path, rack_load, network_work) is admissible both for exact
B&B pruning and for the vectorized stage-1 pruner
(:func:`repro_torch.core.vectorized.batched_lower_bound`, fused on-device via
:func:`repro_torch.kernels.ops.batched_combined_lb`).

Reachability-aware terms (restricted :class:`~repro_torch.core.instance.Topology`)
---------------------------------------------------------------------------
Under a restricted reachability mask two sharpenings apply, both still
admissible (``topology=None`` takes the exact pre-topology code path,
bit-identical):

  * forced-wired edges — a cross-rack edge whose endpoint racks share no
    reachable subchannel must use the wired channel, so its optimistic
    duration is q (not min(q, q̌)) and the wired channel alone must carry
    Σ q over forced edges: makespan >= that serial load.
  * active-subchannel counting — the aggregate channel work only divides
    by subchannels some cross edge of THIS assignment can actually reach
    (1 + |K_active|), so unreachable subchannels no longer dilute the
    bound ("a subchannel's aggregate work only counts racks that can
    reach it").
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.instance import ProblemInstance

__all__ = [
    "upper_bound",
    "lower_bound",
    "longest_branch",
    "critical_path_dist",
    "rack_load_bounds",
    "network_work_bounds",
    "contention_lower_bounds",
    "partial_assignment_bound",
]


def upper_bound(inst: ProblemInstance) -> float:
    """T_max = Σ p_v + Σ r_(u,v): single-rack topological execution."""
    return float(np.sum(inst.job.p) + np.sum(inst.r_local))


def critical_path_dist(
    n: int,
    edges: np.ndarray,
    p: np.ndarray,
    edge_cost: np.ndarray,
    topo: np.ndarray,
) -> np.ndarray:
    """dist(v): longest path from any source to v, where traversing edge
    (u, v) costs p_u + edge_cost_e (Algorithm 1 lines 4-8)."""
    dist = np.zeros(n, dtype=np.float64)
    in_by_node: list[list[int]] = [[] for _ in range(n)]
    for e in range(edges.shape[0]):
        in_by_node[int(edges[e, 1])].append(e)
    for v in topo:
        best = 0.0
        for e in in_by_node[int(v)]:
            u = int(edges[e, 0])
            cand = dist[u] + p[u] + edge_cost[e]
            if cand > best:
                best = cand
        dist[int(v)] = best
    return dist


def longest_branch(inst: ProblemInstance, safe: bool = False) -> float:
    """Algorithm 1: T_min = max_v dist(v) + p_v."""
    job = inst.job
    if safe:
        cost = np.minimum(
            inst.r_local, np.minimum(inst.q_wired, inst.q_wireless)
        )
    else:
        cost = inst.r_local
    dist = critical_path_dist(job.n_tasks, job.edges, job.p, cost, job.topo_order())
    return float(np.max(dist + job.p)) if job.n_tasks else 0.0


def lower_bound(inst: ProblemInstance, safe: bool = True) -> float:
    """T_min. ``safe=True`` guards against instances where local transfer is
    slower than network transfer (not the paper's regime)."""
    return longest_branch(inst, safe=safe)


def min_network_durations(inst: ProblemInstance) -> np.ndarray:
    """Per-edge optimistic network transfer time: min(q, q̌) (q if |K| = 0)."""
    if inst.n_wireless:
        return np.minimum(inst.q_wired, inst.q_wireless)
    return np.asarray(inst.q_wired)


def rack_load_bounds(inst: ProblemInstance, racks: np.ndarray) -> np.ndarray:
    """Per-assignment §IV-A rack-work bound: max_i Σ_{x_v = i} p_v.

    ``racks``: int[B, n_tasks] batch of COMPLETE assignments; returns
    float64[B]. Partial assignments (-1 sentinels) are rejected — wrapping
    them onto the last rack would inflate the bound past admissibility; use
    :func:`partial_assignment_bound` for partial information.
    """
    racks = np.asarray(racks)
    if racks.size and racks.min() < 0:
        raise ValueError("rack_load_bounds needs complete assignments (no -1)")
    B, n = racks.shape
    load = np.zeros((B, inst.n_racks), dtype=np.float64)
    rows = np.arange(B)
    for v in range(n):
        load[rows, racks[:, v]] += inst.job.p[v]
    return load.max(axis=1)


def network_work_bounds(inst: ProblemInstance, racks: np.ndarray) -> np.ndarray:
    """Per-assignment §IV-A channel-work bound.

    Σ over cross-rack edges of min(q, q̌), divided by the 1 + |K| network
    channels (wired ``b`` + wireless subchannels). float64[B].

    With a restricted ``inst.topology`` the bound sharpens (still
    admissible): forced-wired edges (no common reachable subchannel)
    contribute q and must serialize on the wired channel, and the
    aggregate divides by 1 + |K_active| — only subchannels some cross
    edge of the row's assignment can reach.
    """
    racks = np.asarray(racks)
    job = inst.job
    if job.n_edges == 0:
        return np.zeros(racks.shape[0], dtype=np.float64)
    net = min_network_durations(inst)
    eu, ev = job.edges[:, 0], job.edges[:, 1]
    cross = racks[:, eu] != racks[:, ev]
    topo = inst.topology
    if topo is None:
        return (cross * net[None, :]).sum(axis=1) / (1 + inst.n_wireless)
    q = np.asarray(inst.q_wired)
    # [B, E, K]: subchannels usable by each row's placement of each edge.
    edge_reach = topo.pair_reach()[racks[:, eu], racks[:, ev], :]
    ok = edge_reach.any(axis=2)  # [B, E] pair shares >= 1 subchannel
    minfeas = np.where(ok, net[None, :], q[None, :])
    k_active = (edge_reach & cross[:, :, None]).any(axis=1).sum(axis=1)
    agg = (cross * minfeas).sum(axis=1) / (1 + k_active)
    wired_forced = (cross * ~ok * q[None, :]).sum(axis=1)
    return np.maximum(agg, wired_forced)


def contention_lower_bounds(inst: ProblemInstance, racks: np.ndarray) -> np.ndarray:
    """max of the two assignment-conditional §IV-A load bounds. float64[B]."""
    return np.maximum(
        rack_load_bounds(inst, racks), network_work_bounds(inst, racks)
    )


def partial_assignment_bound(
    inst: ProblemInstance,
    rack: np.ndarray,
    topo: np.ndarray,
    min_cost: np.ndarray,
) -> float:
    """LB for a PARTIAL assignment (rack[v] = -1 when undecided): optimistic
    critical path + per-rack work over assigned tasks + aggregate channel
    work over decided cross-rack edges.

    This is the §IV-A bound family generalized to partial information: the
    shared bound hook of the combinatorial B&B
    (:func:`repro_torch.core.bnb.solve_bnb`) and the single-assignment special
    case used by :func:`contention_lower_bounds`.

    Args:
      inst: the instance.
      rack: int[n_tasks] with ``rack[v] = -1`` for undecided tasks; decided
        entries must be in ``[0, inst.n_racks)``.
      topo: int[n_tasks] topological order of the DAG
        (``inst.job.topo_order()``; passed in so B&B amortizes it).
      min_cost: float[n_edges] optimistic per-edge cost for edges with at
        least one undecided endpoint — ``min(r, q, q̌)`` per edge; copied,
        never mutated. Decided edges use their exact local/network cost.

    Returns:
      A float lower bound on the optimal makespan of any completion of
      ``rack`` (monotone: deciding more tasks never decreases it).
      Admissible for both exact B&B pruning and the greedy evaluator.
    """
    job = inst.job
    cost = min_cost.copy()
    net = min_network_durations(inst)
    q = np.asarray(inst.q_wired)
    conn = None
    topology = inst.topology
    if topology is not None:
        conn = topology.pair_connected()
    for e in range(job.n_edges):
        u, v = int(job.edges[e, 0]), int(job.edges[e, 1])
        if rack[u] >= 0 and rack[v] >= 0:
            if rack[u] == rack[v]:
                cost[e] = inst.r_local[e]
            elif conn is None or conn[rack[u], rack[v]]:
                cost[e] = net[e]
            else:
                cost[e] = q[e]  # forced wired: no common subchannel
    dist = critical_path_dist(job.n_tasks, job.edges, job.p, cost, topo)
    lb = float(np.max(dist + job.p))
    for i in range(inst.n_racks):
        sel = rack == i
        if sel.any():
            load = float(job.p[sel].sum())
            if load > lb:
                lb = load
    work = 0.0
    wired_forced = 0.0
    k_active: set[int] | None = None if topology is None else set()
    for e in range(job.n_edges):
        u, v = int(job.edges[e, 0]), int(job.edges[e, 1])
        if rack[u] >= 0 and rack[v] >= 0 and rack[u] != rack[v]:
            if conn is None or conn[rack[u], rack[v]]:
                work += net[e]
                if k_active is not None:
                    k_active.update(
                        topology.edge_channels(int(rack[u]), int(rack[v]))
                    )
            else:
                work += q[e]
                wired_forced += q[e]
    if work > 0.0:
        n_chan = (
            1 + inst.n_wireless if k_active is None else 1 + len(k_active)
        )
        lb = max(lb, work / n_chan)
    if wired_forced > 0.0:
        lb = max(lb, wired_forced)
    return lb
