# Copied from src/repro/core/schedule.py; imports retargeted to repro_torch.
"""Schedule representation and the OP-semantics feasibility checker.

The checker validates a complete schedule directly against the ORIGINAL
problem OP's constraints (1)-(10) (plus the generalized-channel restatement
(11)), independently of any solver. Every solver and baseline in this package
must produce schedules that pass ``check_feasible`` — the property-based test
suite enforces this invariant.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.instance import CH_LOCAL, CH_WIRED, ProblemInstance

__all__ = ["Schedule", "check_feasible", "FeasibilityError"]


class FeasibilityError(AssertionError):
    pass


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A complete joint schedule.

    Attributes:
      rack: int64[n_tasks] rack assignment (0..M-1)        — the x variables.
      start: float64[n_tasks] task start times s_v         — the s variables.
      chan: int64[n_edges] channel per edge (0=b,1=c,2+=K) — the y variables.
      tstart: float64[n_edges] transfer start s_(u,v).
      makespan: max_v s_v + p_v.
    """

    rack: np.ndarray
    start: np.ndarray
    chan: np.ndarray
    tstart: np.ndarray
    makespan: float

    @staticmethod
    def build(
        inst: ProblemInstance,
        rack: np.ndarray,
        start: np.ndarray,
        chan: np.ndarray,
        tstart: np.ndarray,
    ) -> "Schedule":
        # np.array (not asarray): always copy — callers may pass live search
        # buffers that mutate after the schedule is recorded.
        rack = np.array(rack, dtype=np.int64, copy=True)
        start = np.array(start, dtype=np.float64, copy=True)
        chan = np.array(chan, dtype=np.int64, copy=True)
        tstart = np.array(tstart, dtype=np.float64, copy=True)
        mk = float(np.max(start + inst.job.p)) if inst.job.n_tasks else 0.0
        return Schedule(rack=rack, start=start, chan=chan, tstart=tstart, makespan=mk)


def _check_no_overlap(
    starts: np.ndarray, durs: np.ndarray, label: str, tol: float
) -> None:
    """All intervals [start, start+dur) must be pairwise disjoint.

    Zero-duration intervals occupy nothing (a zero-size transfer conflicts
    with no one under constraints (8)/(10)) and are ignored.
    """
    nz = durs > 0
    starts, durs = starts[nz], durs[nz]
    order = np.argsort(starts, kind="stable")
    s = starts[order]
    d = durs[order]
    gaps = s[1:] - (s[:-1] + d[:-1])
    if gaps.size and float(gaps.min()) < -tol:
        i = int(np.argmin(gaps))
        raise FeasibilityError(
            f"{label}: overlap between interval {i} and {i + 1}: "
            f"[{s[i]}, {s[i] + d[i]}) vs [{s[i + 1]}, ...)"
        )


def check_feasible(
    inst: ProblemInstance, sched: Schedule, tol: float = 1e-6
) -> float:
    """Validate ``sched`` against OP's constraints. Returns the makespan.

    Raises FeasibilityError with a diagnostic message on the first violation.
    """
    job = inst.job
    n, m = job.n_tasks, job.n_edges
    rack, start = sched.rack, sched.start
    chan, tstart = sched.chan, sched.tstart

    if rack.shape != (n,) or start.shape != (n,):
        raise FeasibilityError("bad task arrays")
    if chan.shape != (m,) or tstart.shape != (m,):
        raise FeasibilityError("bad edge arrays")

    # (1) Non-repetition: rack in range (one rack per task by representation).
    if n and (rack.min() < 0 or rack.max() >= inst.n_racks):
        raise FeasibilityError("rack assignment out of range")
    if n and float(start.min()) < -tol:
        raise FeasibilityError("negative task start")
    if m and float(tstart.min()) < -tol:
        raise FeasibilityError("negative transfer start")
    # (11) channel in range.
    if m and (chan.min() < 0 or chan.max() >= inst.n_channels):
        raise FeasibilityError("channel assignment out of range")

    dur = inst.duration_on(chan)

    # (4)/(26) Channel/locality consistency: local channel iff same rack.
    for e in range(m):
        u, v = job.edges[e]
        same = rack[u] == rack[v]
        if same != (chan[e] == CH_LOCAL):
            raise FeasibilityError(
                f"edge {e} ({u}->{v}): same_rack={bool(same)} but channel={chan[e]}"
            )

    # (6) transfer starts after producer completes.
    for e in range(m):
        u, v = job.edges[e]
        if tstart[e] < start[u] + job.p[u] - tol:
            raise FeasibilityError(
                f"edge {e}: transfer starts at {tstart[e]} before task {u} "
                f"completes at {start[u] + job.p[u]}"
            )
        # (5)/(7)/(9): consumer starts after transfer completes.
        if start[v] < tstart[e] + dur[e] - tol:
            raise FeasibilityError(
                f"edge {e}: task {v} starts at {start[v]} before transfer "
                f"completes at {tstart[e] + dur[e]}"
            )

    # (3) precedence (implied by the above, but checked for the slack form).
    for e in range(m):
        u, v = job.edges[e]
        if start[v] < start[u] + job.p[u] - tol:
            raise FeasibilityError(f"precedence violated on edge {u}->{v}")

    # (2) rack non-overlap.
    for i in range(inst.n_racks):
        sel = np.nonzero(rack == i)[0]
        if sel.size > 1:
            _check_no_overlap(start[sel], job.p[sel], f"rack {i}", tol)

    # (8) wired-channel exclusivity (single shared channel b).
    sel = np.nonzero(chan == CH_WIRED)[0]
    if sel.size > 1:
        _check_no_overlap(tstart[sel], dur[sel], "wired channel b", tol)

    # (10) per-subchannel wireless exclusivity.
    for k in range(inst.n_wireless):
        sel = np.nonzero(chan == 2 + k)[0]
        if sel.size > 1:
            _check_no_overlap(tstart[sel], dur[sel], f"wireless subchannel {k}", tol)

    mk = float(np.max(start + job.p)) if n else 0.0
    if abs(mk - sched.makespan) > max(tol, 1e-9 * max(1.0, abs(mk))):
        raise FeasibilityError(
            f"recorded makespan {sched.makespan} != recomputed {mk}"
        )
    return mk
