# Copied from src/repro/core/baselines.py; imports retargeted to repro_torch.
"""Baseline schedulers (paper §V, Fig. 4).

Six wired-only baselines are compared against the paper's optimal method:

  * Random Scheduling          — uniform random rack per task.
  * List Scheduling [20]       — classic ETF list scheduling; communication
                                 counted as a delay but the network treated as
                                 uncapacitated during GREEDY DECISIONS (the
                                 Rayward-Smith model); the resulting
                                 assignment is then executed under real
                                 contention by the simulator.
  * Partition Scheduling [19]  — topological chunking into load-balanced
                                 contiguous partitions, one rack each.
  * G-List Scheduling [19]     — generalized list scheduling: network
                                 transfers are first-class operations that
                                 reserve capacity on the shared wired channel
                                 (and wireless subchannels when enabled).
  * G-List-Master [19]         — G-List restricted to predecessor racks plus
                                 the least-loaded fresh rack (data-locality /
                                 "master" placement flavor).
  * Optimal (wired only)       — the paper's own solver with K = ∅.

All baselines return feasibility-checked Schedules. Exact pseudo-code for the
[19] heuristics is not public; implementations follow the descriptions above
and are documented as interpretations in DESIGN.md.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.instance import CH_WIRED, ProblemInstance
from repro_torch.core.schedule import Schedule
from repro_torch.core.simulator import (
    _Timeline,
    critical_path_priority,
    seed_channel_timelines,
    simulate,
)

__all__ = [
    "single_rack_schedule",
    "random_schedule",
    "list_schedule",
    "partition_schedule",
    "g_list_schedule",
    "g_list_master_schedule",
    "fifo_solo_schedule",
    "edf_solo_schedule",
    "greedy_list_online_schedule",
    "wired_only",
    "BASELINES",
    "ONLINE_BASELINES",
]


def wired_only(inst: ProblemInstance) -> ProblemInstance:
    """Drop wireless resources (the paper's wired-only optimal)."""
    return ProblemInstance(
        job=inst.job,
        n_racks=inst.n_racks,
        n_wireless=0,
        wired_rate=inst.wired_rate,
        wireless_rate=inst.wireless_rate,
        local_delay=inst.local_delay,
    )


def single_rack_schedule(inst: ProblemInstance) -> Schedule:
    """All tasks on rack 0 — attains the §IV-A upper bound T_max."""
    rack = np.zeros(inst.job.n_tasks, dtype=np.int64)
    return simulate(inst, rack, use_wireless=False)


def random_schedule(
    inst: ProblemInstance, rng: np.random.Generator, use_wireless: bool = False
) -> Schedule:
    rack = rng.integers(0, inst.n_racks, size=inst.job.n_tasks)
    return simulate(inst, rack, use_wireless=use_wireless)


def list_schedule(
    inst: ProblemInstance,
    use_wireless: bool = False,
    channel_busy: dict | None = None,
) -> Schedule:
    """ETF list scheduling with uncapacitated-network estimates [20].

    Greedy pass chooses racks assuming transfers never contend; the final
    schedule is produced by the contention-aware simulator on that
    assignment. ``channel_busy`` (the simulator's replay hook) lets the
    online service hand over pre-existing busy intervals of the shared
    physical channels, so the executed schedule gap-inserts around other
    jobs' committed transfers.
    """
    job = inst.job
    n = job.n_tasks
    prio = critical_path_priority(inst, pessimistic=True)
    order = np.argsort(-prio, kind="stable")

    rack = np.full(n, -1, dtype=np.int64)
    finish = np.zeros(n)
    rack_free = np.zeros(inst.n_racks)
    q = inst.q_wired
    r = inst.r_local

    # Process tasks in priority order, but only when predecessors are placed
    # (argsort of downstream-path priority is precedence-compatible for DAGs
    # with positive processing times; assert to be safe).
    placed = np.zeros(n, dtype=bool)
    for v in order:
        v = int(v)
        for e in job.in_edges(v):
            assert placed[int(job.edges[e, 0])], "priority order not topological"
        best = None
        for i in range(inst.n_racks):
            arrival = 0.0
            for e in job.in_edges(v):
                u = int(job.edges[e, 0])
                delay = r[e] if rack[u] == i else q[e]
                arrival = max(arrival, finish[u] + delay)
            s = max(arrival, rack_free[i])
            key = (s + job.p[v], s, i)
            if best is None or key < best:
                best = key
        assert best is not None
        _, s, i = best
        rack[v] = i
        finish[v] = s + job.p[v]
        rack_free[i] = finish[v]
        placed[v] = True
    return simulate(
        inst, rack, use_wireless=use_wireless, channel_busy=channel_busy
    )


def partition_schedule(inst: ProblemInstance, use_wireless: bool = False) -> Schedule:
    """Topological chunking into ≤M load-balanced contiguous partitions [19]."""
    job = inst.job
    topo = job.topo_order()
    total = float(np.sum(job.p))
    n_parts = min(inst.n_racks, max(1, job.n_tasks))
    target = total / n_parts
    rack = np.zeros(job.n_tasks, dtype=np.int64)
    acc, part = 0.0, 0
    for v in topo:
        rack[int(v)] = part
        acc += float(job.p[int(v)])
        if acc >= target * (part + 1) and part < n_parts - 1:
            part += 1
    return simulate(inst, rack, use_wireless=use_wireless)


def _g_list(
    inst: ProblemInstance,
    use_wireless: bool,
    candidate_racks,
    channel_busy: dict | None = None,
) -> Schedule:
    """Shared engine for G-List variants: contention-aware greedy placement.

    ``candidate_racks(v, rack, load)`` yields the rack ids considered for v.
    ``channel_busy`` seeds the channel timelines with pre-existing busy
    intervals (other jobs' committed transfers, in this instance's time
    frame), so both the greedy channel choices and the final placement
    respect cross-job contention on the shared physical channels.
    """
    job = inst.job
    n, m = job.n_tasks, job.n_edges
    prio = critical_path_priority(inst, pessimistic=True)
    order = np.argsort(-prio, kind="stable")

    rack = np.full(n, -1, dtype=np.int64)
    chan = np.full(m, -1, dtype=np.int64)
    rack_tl = [_Timeline() for _ in range(inst.n_racks)]
    chan_ids = [CH_WIRED] + ([2 + k for k in range(inst.n_wireless)] if use_wireless else [])
    # Wireless subchannel 2+k is a candidate for a cross-rack edge only when
    # both endpoint racks reach k; wired (always reachable) backstops every
    # pair, so the candidate list below is never empty.
    reach = None if inst.topology is None else inst.topology.reach
    chan_tl = {c: _Timeline() for c in chan_ids}
    # Non-strict: channels this variant does not place on (e.g. wireless
    # under use_wireless=False) cannot conflict, so their intervals are
    # irrelevant rather than an error.
    seed_channel_timelines(chan_tl, channel_busy, strict=False)
    dur = inst.durations_matrix()
    start = np.zeros(n)
    finish = np.zeros(n)
    tstart = np.zeros(m)

    for v in order:
        v = int(v)
        in_es = [int(e) for e in job.in_edges(v)]
        best = None
        for i in candidate_racks(v, rack, finish):
            # Tentative: earliest arrival of all inputs if v runs on rack i.
            # Channel picks must see each other, so reserve into scratch
            # copies of the channel timelines during evaluation.
            scratch = {c: list(chan_tl[c].busy) for c in chan_ids}
            arrival = 0.0
            picks: list[tuple[int, int, float]] = []  # (edge, channel, start)
            for e in in_es:
                u = int(job.edges[e, 0])
                if rack[u] == i:
                    picks.append((e, 1, finish[u]))  # CH_LOCAL
                    arrival = max(arrival, finish[u] + dur[e, 1])
                else:
                    cbest = None
                    for c in chan_ids:
                        if (
                            reach is not None
                            and c >= 2
                            and not (reach[rack[u], c - 2] and reach[i, c - 2])
                        ):
                            continue
                        tl = _Timeline()
                        tl.busy = scratch[c]
                        s = tl.earliest_fit(finish[u], float(dur[e, c]))
                        k = (s + float(dur[e, c]), s, c)
                        if cbest is None or k < cbest:
                            cbest = k
                    assert cbest is not None
                    fin, s, c = cbest
                    picks.append((e, c, s))
                    scratch[c] = sorted(scratch[c] + [(s, fin)])
                    arrival = max(arrival, fin)
            s_v = rack_tl[i].earliest_fit(arrival, float(job.p[v]))
            key = (s_v + float(job.p[v]), s_v, i)
            if best is None or key < best[0]:
                best = (key, i, picks, s_v)
        assert best is not None
        _, i, picks, s_v = best
        rack[v] = i
        for e, c, s in picks:
            chan[e] = c
            tstart[e] = s
            if c != 1:  # local channel has no capacity
                chan_tl[c].insert(s, float(dur[e, c]))
        rack_tl[i].insert(s_v, float(job.p[v]))
        start[v] = s_v
        finish[v] = s_v + float(job.p[v])

    sched = Schedule.build(inst, rack, start, chan, tstart)
    from repro_torch.core.schedule import check_feasible

    check_feasible(inst, sched)
    return sched


def g_list_schedule(
    inst: ProblemInstance,
    use_wireless: bool = False,
    channel_busy: dict | None = None,
) -> Schedule:
    return _g_list(
        inst,
        use_wireless,
        lambda v, rack, fin: range(inst.n_racks),
        channel_busy=channel_busy,
    )


def g_list_master_schedule(
    inst: ProblemInstance, use_wireless: bool = False
) -> Schedule:
    """G-List restricted to predecessor racks + one fresh least-used rack."""
    job = inst.job

    def candidates(v: int, rack: np.ndarray, finish: np.ndarray):
        preds = {int(rack[int(job.edges[e, 0])]) for e in job.in_edges(v)}
        preds.discard(-1)
        used = set(int(x) for x in rack if x >= 0)
        fresh = [i for i in range(inst.n_racks) if i not in used]
        cands = sorted(preds) + (fresh[:1] if fresh else [])
        if not cands:
            cands = [0]
        return cands

    return _g_list(inst, use_wireless, candidates)


BASELINES = {
    "random": random_schedule,
    "list": list_schedule,
    "partition": partition_schedule,
    "g_list": g_list_schedule,
    "g_list_master": g_list_master_schedule,
}


# ---------------------------------------------------------------------------
# Online (arrival-driven) baselines
# ---------------------------------------------------------------------------
#
# The online serving layer (:mod:`repro_torch.online.service`) schedules each
# admitted job with a per-job policy function ``(inst, use_wireless) ->
# Schedule``. The two entries below are the classic online comparison
# points for the arrival-driven benchmarks; ``"fleet"`` (the mega-batch
# search engine with warm-started re-optimization) is the policy under
# test and lives in the service itself.


def fifo_solo_schedule(
    inst: ProblemInstance,
    use_wireless: bool = True,
    channel_busy: dict | None = None,
) -> Schedule:
    """Per-job scheduler of the online *FIFO-solo* baseline.

    FIFO-solo serves jobs strictly one at a time in arrival order, each
    getting the whole cluster to itself (the service enforces the solo
    admission rule — whole cluster idle, head-of-line job only); the
    per-job schedule is ETF list scheduling executed under real
    contention. JCT is then dominated by head-of-line queueing, which is
    what the batched fleet policy is measured against. ``channel_busy``
    is accepted for signature uniformity with the other online baselines
    (the service commits every policy through the same channel-feasible
    arbitration path); under the solo rule the cluster is idle at
    admission, so it is always empty.
    """
    return list_schedule(
        inst, use_wireless=use_wireless, channel_busy=channel_busy
    )


def edf_solo_schedule(
    inst: ProblemInstance,
    use_wireless: bool = True,
    channel_busy: dict | None = None,
) -> Schedule:
    """Per-job scheduler of the online *EDF-solo* baseline.

    The deadline-aware twin of :func:`fifo_solo_schedule`: identical
    per-job placement (critical-path list scheduling on the idle
    cluster), but the service orders its solo queue earliest-deadline
    first instead of by arrival (``OnlineScheduler(policy="edf_solo")``
    implies ``admission="edf"``). Keeping the placement bit-identical to
    FIFO-solo makes the pair an apples-to-apples measurement of the
    *admission order* alone — any deadline-miss delta between them is
    attributable to EDF, not to solver quality.
    """
    return list_schedule(
        inst, use_wireless=use_wireless, channel_busy=channel_busy
    )


def greedy_list_online_schedule(
    inst: ProblemInstance,
    use_wireless: bool = True,
    channel_busy: dict | None = None,
) -> Schedule:
    """Per-job scheduler of the online *greedy-list* baseline.

    Greedy-list admits jobs onto residual capacity exactly like the fleet
    policy (same windows, same residual instances, same channel-feasible
    arbitrated commits) but places each job with the contention-aware
    G-List heuristic instead of searching — no candidate batches, no warm
    starts. ``channel_busy`` carries the busy intervals already committed
    on the job's physical channels, so the heuristic's channel choices
    see cross-job contention too. It isolates the value of the search
    engine from the value of the admission machinery.
    """
    return g_list_schedule(
        inst, use_wireless=use_wireless, channel_busy=channel_busy
    )


ONLINE_BASELINES = {
    "fifo_solo": fifo_solo_schedule,
    "edf_solo": edf_solo_schedule,
    "greedy_list": greedy_list_online_schedule,
}
