# Copied from src/repro/online/cluster.py; imports retargeted to repro_torch.
"""Global cluster timeline: residual capacity and channel-feasible commits.

The offline engine solves each :class:`~repro_torch.core.instance.ProblemInstance`
against a *private* resource view (its own racks and subchannels). Online,
admitted jobs occupy the shared cluster over time, so a newly arrived job
must be solved against what is actually free, and its committed transfers
must not overlap other jobs' transfers on the same physical link.
:class:`ClusterTimeline` therefore tracks two things per physical resource:

* a **hold time** (per rack and per wireless subchannel) — the time until
  which the resource is granted to a committed job; grants are exclusive,
  so holds gate admission, and
* the **busy intervals** of every physical channel — the single wired
  channel and each wireless subchannel — carrying the exact committed
  transfer windows of every job, with the owning job id.

Occupancy model: **racks and wireless subchannels are exclusive grants** —
jobs admitted at the same epoch draw disjoint grants from shrinking pools
(the service passes ``rack_pool`` / ``wireless_pool``), a committed job
holds each granted rack until its last task there finishes and each granted
subchannel until its last transfer there finishes, and held resources are
excluded from later epochs' residual views. **The wired channel is shared
by every job** and is never granted; instead every commit passes through
:meth:`ClusterTimeline.arbitrate` — a deterministic commit-order
arbitration pass that replays the job's schedule through the host
simulator (:func:`repro_torch.core.simulator.simulate` with the ``channel_busy``
hook) against the busy intervals already committed on its physical
channels. The replay keeps the engine's intra-job decisions (task->rack
and edge->channel vectors) and only shifts start times, gap-inserting the
job's transfers around other jobs' — so every committed timeline is
physically feasible: no two jobs ever overlap on the wired channel or on
one wireless subchannel (:meth:`ClusterTimeline.assert_feasible` audits
exactly this), and reported utilizations are true fractions in [0, 1].

Interval index (the O(active) serving core): every per-resource interval
list is maintained **sorted by start** with ``bisect.insort``. Committed
intervals on one resource are pairwise disjoint (the feasibility
invariant), so their end times are sorted too, and
:meth:`ClusterTimeline.channel_busy` answers "which intervals end after
``t``" with one bisect on the end column — O(log n + hits) instead of a
full-history scan. :meth:`ClusterTimeline.compact` retires intervals
ending at or before a frontier ``t``: epochs are monotone and every
residual/busy query at ``t' >= t`` drops such intervals anyway, so
compaction is *observationally identical* — busy-time accumulators were
already charged at commit, holds are untouched, and ``channel_busy`` /
``arbitrate`` / ``utilization`` return bit-identical answers (the
equivalence property is locked by ``tests/test_online_scale.py``). After
compaction the steady-state cost of every timeline operation depends only
on the intervals of *active* jobs, not on the full arrival history.

The feasibility audit is incremental on the same index: commits buffer
their new intervals, and :meth:`assert_feasible` checks only those against
their sorted neighbors (``full=True`` rescans every retained interval from
scratch — the test-suite escape hatch). :meth:`compact` audits the pending
buffer before dropping anything, so no committed interval is ever retired
unaudited.

When a job's physical channels carry no committed intervals past the
admission epoch, ``arbitrate`` returns the schedule object unchanged —
with an empty cluster, one admission epoch, disjoint grants and no
cross-job wired traffic, the online service still reduces bit-for-bit to
one ``schedule_fleet`` call (locked by ``tests/test_online.py::
test_degenerate_arrivals_match_schedule_fleet``).

Reconfigurable topology: constructed with a cluster-level
:class:`~repro_torch.core.instance.Topology`, the timeline additionally tracks
**which wireless links are configured** (``matching``, a per-epoch greedy
weighted b-matching over the topology's candidate links; see
:meth:`ClusterTimeline.reconfigure`) and **which are physically up**
(``link_state``, flipped by seeded outage traces via
:meth:`ClusterTimeline.set_link`). Residual views then carry the induced
:class:`~repro_torch.core.instance.Topology` on their granted racks ×
subchannels, so every solver stage — bounds, kernels, simulator —
respects the active links. Reconfiguring a subchannel charges the
topology's δ as a busy interval (owner id ``RECONFIG_JOB``) on that
subchannel, audited by :meth:`assert_feasible` like any transfer; only
subchannels idle at the epoch are ever reconfigured, links mid-transfer
are pinned. With ``topology=None`` (default) all of this is inert and the
timeline is bit-identical to the pre-topology code.

Float semantics: holds are recorded at exact float completion times and
``free_racks`` / ``free_wireless`` use an exact ``hold <= t`` comparison —
a resource released at exactly ``t`` is re-grantable at ``t``, while an
in-flight hold any amount past ``t`` (even within the old ``_EPS``
tolerance window) is busy, so back-to-back admissions can never
double-book (regression-locked in ``tests/test_online.py``). ``_EPS`` is
kept only as the audit's overlap tolerance.
"""

from __future__ import annotations

import bisect
import dataclasses
import operator

import numpy as np

from repro_torch.core.instance import CH_WIRED, ProblemInstance, Topology
from repro_torch.core.schedule import Schedule
from repro_torch.core.simulator import simulate
from repro_torch.obs.trace import as_tracer

__all__ = [
    "ClusterTimeline",
    "OrderReplay",
    "RECONFIG_JOB",
    "ResidualView",
    "channel_delay_attribution",
    "job_holds",
    "replay_commit_order",
    "reservation_backfill_safe",
    "wired_windows",
]

# Overlap tolerance for the feasibility audit. Grant/release comparisons are
# exact (see the module docstring); this only absorbs float noise when two
# independently computed transfer windows abut.
_EPS = 1e-9

# Sort key of one committed interval: its end time. Intervals on one
# resource are disjoint (the feasibility invariant), so the start-sorted
# index has sorted ends too and both columns bisect.
_END = operator.itemgetter(1)

# Owner id of δ reconfiguration intervals on wireless subchannels (no real
# job ever commits with this id; the service reserves -1 for anonymous
# commits, so reconfigurations get their own marker).
RECONFIG_JOB = -2


@dataclasses.dataclass(frozen=True)
class ResidualView:
    """A job's residual-capacity view of the cluster at one epoch.

    Attributes:
      inst: the residual instance — the job's DAG with ``n_racks`` =
        granted racks and ``n_wireless`` = granted subchannels (0 when all
        are held: the job runs wired-only).
      rack_map: int[granted] physical rack id of each local rack index.
      wireless_map: int[granted_wireless] physical subchannel index
        (0-based) of each local subchannel index.
      full: True iff the view grants the job's full demanded shape.
    """

    inst: ProblemInstance
    rack_map: np.ndarray
    wireless_map: np.ndarray
    full: bool


class ClusterTimeline:
    """Hold-until-free grants plus per-channel busy intervals of one cluster.

    Args:
      n_racks: M physical racks.
      n_wireless: |K| physical wireless subchannels.
      topology: optional cluster-level
        :class:`~repro_torch.core.instance.Topology` over
        ``[n_racks, n_wireless]``. When given, residual views carry the
        induced topology of the currently configured + up links, and
        :meth:`reconfigure` / :meth:`set_link` manage the matching and
        outage state. ``None`` (default) = the paper's model, bit-identical
        to the pre-topology timeline.
      tracer: optional :class:`repro_torch.obs.trace.Tracer` receiving
        compaction and audit-backlog events (``None`` = no tracing).
    """

    def __init__(
        self,
        n_racks: int,
        n_wireless: int,
        *,
        topology: Topology | None = None,
        tracer=None,
    ):
        self.tracer = as_tracer(tracer)
        if n_racks < 1:
            raise ValueError("cluster needs at least one rack")
        if n_wireless < 0:
            raise ValueError("n_wireless must be non-negative")
        self.n_racks = int(n_racks)
        self.n_wireless = int(n_wireless)
        if topology is not None and topology.reach.shape != (
            self.n_racks,
            self.n_wireless,
        ):
            raise ValueError(
                f"cluster topology shape {topology.reach.shape} != "
                f"({self.n_racks}, {self.n_wireless})"
            )
        self.topology = topology
        # Configured links (the current matching) and physical link health.
        # Start fully configured: "static" serving never reconfigures and
        # simply exposes reach & link_state.
        self.matching = None if topology is None else topology.reach.copy()
        self.link_state = (
            None
            if topology is None
            else np.ones((self.n_racks, self.n_wireless), dtype=bool)
        )
        self.n_reconfigs = 0
        self.rack_hold = np.zeros(self.n_racks, dtype=np.float64)
        self.wireless_hold = np.zeros(self.n_wireless, dtype=np.float64)
        # Committed occupancy, (start, end, job_id) in absolute time. Each
        # list is a sorted interval index (ascending starts; disjoint
        # intervals make the ends ascending too).
        self.rack_intervals: list[list[tuple[float, float, int]]] = [
            [] for _ in range(self.n_racks)
        ]
        self.wired_intervals: list[tuple[float, float, int]] = []
        self.wireless_intervals: list[list[tuple[float, float, int]]] = [
            [] for _ in range(self.n_wireless)
        ]
        # Busy-time accumulators for utilization metrics. Charged at
        # commit, so compaction never has to re-derive them.
        self.rack_busy_time = 0.0
        self.wired_busy_time = 0.0
        self.wireless_busy_time = 0.0
        self.last_completion = 0.0
        # Compaction frontier: intervals ending at or before it have been
        # retired from the index (their busy time stays accumulated).
        self.compact_frontier = 0.0
        self.n_compacted = 0
        # Intervals committed since the last audit: (label, index_list,
        # interval) triples checked incrementally by assert_feasible.
        self._audit_backlog: list[
            tuple[str, list[tuple[float, float, int]], tuple[float, float, int]]
        ] = []

    # -- reconfigurable topology ---------------------------------------------

    def active_reach(self) -> np.ndarray | None:
        """bool[n_racks, n_wireless] of usable links — configured by the
        current matching AND physically up — or ``None`` without a
        cluster topology."""
        if self.topology is None:
            return None
        return self.matching & self.link_state

    def topology_signature(self):
        """Hashable fingerprint of the active link set (``None`` without a
        topology): folds into the service's availability signature so
        matching / outage changes invalidate ``replan="changed"`` plans."""
        if self.topology is None:
            return None
        return (self.matching & self.link_state).tobytes()

    def set_link(self, rack: int, k: int, up: bool) -> bool:
        """Flip one physical link's health (outage / repair); returns
        whether the state changed. Links mid-transfer stay committed —
        outages only gate *future* views and matchings."""
        if self.topology is None:
            raise RuntimeError("set_link needs a cluster topology")
        up = bool(up)
        if self.link_state[rack, k] == up:
            return False
        self.link_state[rack, k] = up
        return True

    def reconfigure(self, weight: np.ndarray, t: float) -> int:
        """Re-match the wireless links to this epoch's demand at time ``t``.

        Runs the topology's greedy weighted b-matching
        (:meth:`~repro_torch.core.instance.Topology.match`) over the links that
        are physically up, with two timeline-imposed rules: subchannels
        still busy at ``t`` (``wireless_hold > t``) keep their configured
        links — those are pinned into the matching and count toward the
        degree limits — and every *idle* subchannel whose link set changes
        is charged the reconfiguration delay δ as a busy interval
        ``[t, t + δ)`` owned by :data:`RECONFIG_JOB` (disjoint by
        construction: an idle subchannel has no committed interval ending
        after ``t``). Returns the number of subchannels reconfigured.
        No-op (returns 0) without a cluster topology.
        """
        if self.topology is None:
            return 0
        idle = self.wireless_hold <= t
        keep = self.matching.copy()
        keep[:, idle] = False
        feasible = self.link_state.copy()
        feasible[:, ~idle] = False
        new = self.topology.match(
            np.asarray(weight, dtype=np.float64), feasible=feasible, keep=keep
        )
        changed = ((new != self.matching).any(axis=0)) & idle
        n_changed = int(changed.sum())
        delta = float(self.topology.delta)
        if delta > 0.0 and n_changed:
            for k in np.nonzero(changed)[0]:
                self._insert(
                    f"wireless subchannel {k}",
                    self.wireless_intervals[int(k)],
                    (t, t + delta, RECONFIG_JOB),
                )
                self.wireless_hold[k] = max(self.wireless_hold[k], t + delta)
                self.wireless_busy_time += delta
        self.matching = new
        self.n_reconfigs += n_changed
        return n_changed

    # -- residual capacity ---------------------------------------------------

    def free_racks(self, t: float) -> np.ndarray:
        """Physical rack ids free at time ``t`` (ascending, exact release)."""
        return np.nonzero(self.rack_hold <= t)[0]

    def free_wireless(self, t: float) -> np.ndarray:
        """Physical wireless subchannel indices free at time ``t``."""
        return np.nonzero(self.wireless_hold <= t)[0]

    def residual_view(
        self,
        inst: ProblemInstance,
        t: float,
        rack_pool: np.ndarray | None = None,
        wireless_pool: np.ndarray | None = None,
    ) -> ResidualView | None:
        """Residual-capacity instance for ``inst`` at epoch ``t``.

        Grants ``min(inst.n_racks, |rack_pool|)`` racks and
        ``min(inst.n_wireless, |wireless_pool|)`` wireless subchannels —
        the lowest-id entries of each pool, or of the free sets at ``t``
        when no pool is given. The service passes shrinking pools so that
        resources granted within one epoch are mutually exclusive, for
        racks and subchannels alike. Returns ``None`` when the rack pool
        is empty — the job cannot be admitted at this epoch.
        """
        free_r = self.free_racks(t) if rack_pool is None else np.asarray(rack_pool)
        if free_r.size == 0:
            return None
        granted = free_r[: inst.n_racks]
        free_w = (
            self.free_wireless(t) if wireless_pool is None else np.asarray(wireless_pool)
        )[: inst.n_wireless]
        topo = None
        if self.topology is not None:
            # The induced topology of the currently usable links on the
            # granted racks × subchannels; the solver stack (bounds,
            # kernels, simulator) gates channel picks on it.
            topo = dataclasses.replace(
                self.topology,
                reach=self.active_reach()[
                    np.ix_(granted.astype(np.int64), free_w.astype(np.int64))
                ],
            )
        residual = ProblemInstance(
            job=inst.job,
            n_racks=int(granted.size),
            n_wireless=int(free_w.size),
            wired_rate=inst.wired_rate,
            wireless_rate=inst.wireless_rate,
            local_delay=inst.local_delay,
            topology=topo,
        )
        full = granted.size == inst.n_racks and free_w.size == inst.n_wireless
        return ResidualView(
            inst=residual,
            rack_map=granted.astype(np.int64),
            wireless_map=free_w.astype(np.int64),
            full=bool(full),
        )

    # -- cross-job arbitration ----------------------------------------------

    @staticmethod
    def _tail(
        intervals: list[tuple[float, float, int]], t: float
    ) -> list[tuple[float, float, int]]:
        """Intervals ending strictly after ``t``: one bisect on the sorted
        end column, then the contiguous tail of the index."""
        i = bisect.bisect_right(intervals, t, key=_END)
        return intervals[i:]

    def channel_busy(
        self,
        view: ResidualView,
        t: float,
        wired_extra: list[tuple[float, float]] | tuple = (),
    ) -> dict:
        """Committed busy intervals on ``view``'s physical channels, mapped
        into the view's local frame (channel ids CH_WIRED / 2+k, times
        relative to ``t``). Intervals ending at or before ``t`` are
        dropped; an interval straddling ``t`` keeps its negative-start
        tail (the simulator's gap search handles it). Channels with no
        remaining intervals are omitted, so an empty dict certifies the
        job's channels are clear from ``t`` on. O(log n + hits) per
        channel on the sorted interval index; ``t`` must not precede the
        compaction frontier (retired intervals cannot be reconstructed).

        ``wired_extra`` appends *hypothetical* wired intervals in absolute
        time on top of the committed index — the trial-commit feed of
        :func:`replay_commit_order`, which accumulates the wired windows
        earlier jobs of a candidate order would commit without mutating
        the timeline. The simulator sorts seeded intervals itself, so the
        extras need no order. With the default empty extras the answer is
        bit-identical to the two-argument form.
        """
        if t < self.compact_frontier:
            raise RuntimeError(
                f"channel_busy at t={t} precedes the compaction frontier "
                f"{self.compact_frontier}: intervals ending before the "
                "frontier have been retired and cannot be replayed"
            )
        busy: dict[int, list[tuple[float, float]]] = {}
        wired = [(s - t, e - t) for s, e, _ in self._tail(self.wired_intervals, t)]
        for s, e in wired_extra:
            if e > t:
                wired.append((s - t, e - t))
        if wired:
            busy[CH_WIRED] = wired
        for k in range(view.inst.n_wireless):
            phys = int(view.wireless_map[k])
            ivs = [
                (s - t, e - t)
                for s, e, _ in self._tail(self.wireless_intervals[phys], t)
            ]
            if ivs:
                busy[2 + k] = ivs
        return busy

    def arbitrate(
        self,
        view: ResidualView,
        sched: Schedule,
        t: float,
        wired_extra: list[tuple[float, float]] | tuple = (),
    ) -> Schedule:
        """Sequence ``sched`` onto the shared physical channels at ``t``.

        The cross-job arbitration pass: replays the schedule through the
        host simulator with the busy intervals already committed on the
        job's physical channels, keeping the engine's task->rack and
        edge->channel decisions and re-deriving exact start times (the
        job's transfers gap-insert around other jobs'). Deterministic for
        a fixed commit order, and the identity when the job's channels
        carry no committed intervals past ``t`` — so an uncontended
        commit stays bit-for-bit the engine's schedule. ``wired_extra``
        (absolute-time hypothetical wired intervals) is the trial-commit
        hook of :func:`replay_commit_order`; empty by default.
        """
        busy = self.channel_busy(view, t, wired_extra=wired_extra)
        if not busy:
            return sched
        return simulate(view.inst, sched.rack, chan=sched.chan, channel_busy=busy)

    # -- commit --------------------------------------------------------------

    def _insert(
        self,
        label: str,
        intervals: list[tuple[float, float, int]],
        iv: tuple[float, float, int],
    ) -> None:
        """Sorted insert into one resource's interval index, buffering the
        interval for the incremental feasibility audit."""
        bisect.insort(intervals, iv)
        self._audit_backlog.append((label, intervals, iv))

    def commit(
        self,
        view: ResidualView,
        sched: Schedule,
        t: float,
        job_id: int = -1,
        holds_out: list | None = None,
    ) -> float:
        """Place ``sched`` (solved in the residual view's local frame,
        relative time 0) onto the cluster starting at absolute time ``t``.

        Each granted rack the job uses is held until the job's last task
        on it finishes, and each granted wireless subchannel until the
        job's last transfer on it finishes; every transfer's exact window
        is recorded on its physical channel (the wired channel included).
        The caller is responsible for channel feasibility — pass the
        schedule through :meth:`arbitrate` first when the cluster is not
        empty; :meth:`assert_feasible` audits the invariant after the
        fact. ``holds_out``, when given, receives one
        ``("rack" | "wireless", physical_id, hold_time)`` triple per
        resource this commit (re)holds — the delta feed for the service's
        incrementally maintained free sets. Returns the job's absolute
        completion time (``t + makespan``).
        """
        inst = view.inst
        job = inst.job
        dur = inst.duration_on(sched.chan)
        held_w: dict[int, float] = {}
        for i in range(inst.n_racks):
            on_i = sched.rack == i
            if not on_i.any():
                continue
            fin = float(np.max(sched.start[on_i] + job.p[on_i]))
            phys = int(view.rack_map[i])
            self.rack_hold[phys] = max(self.rack_hold[phys], t + fin)
            if holds_out is not None:
                holds_out.append(("rack", phys, self.rack_hold[phys]))
            self.rack_busy_time += float(np.sum(job.p[on_i]))
            for s, p in zip(sched.start[on_i], job.p[on_i]):
                if p > 0:
                    self._insert(
                        f"rack {phys}",
                        self.rack_intervals[phys],
                        (t + float(s), t + float(s) + float(p), job_id),
                    )
        if job.n_edges:
            for e in range(job.n_edges):
                c, d = int(sched.chan[e]), float(dur[e])
                if d <= 0.0:
                    continue  # zero-size transfers occupy nothing
                s = float(sched.tstart[e])
                if c == CH_WIRED:
                    self._insert(
                        "wired channel",
                        self.wired_intervals,
                        (t + s, t + s + d, job_id),
                    )
                    self.wired_busy_time += d
                elif c >= 2:
                    phys = int(view.wireless_map[c - 2])
                    self._insert(
                        f"wireless subchannel {phys}",
                        self.wireless_intervals[phys],
                        (t + s, t + s + d, job_id),
                    )
                    self.wireless_hold[phys] = max(
                        self.wireless_hold[phys], t + s + d
                    )
                    held_w[phys] = self.wireless_hold[phys]
                    self.wireless_busy_time += d
        if holds_out is not None:
            for phys, hold in held_w.items():
                holds_out.append(("wireless", phys, hold))
        completion = t + sched.makespan
        self.last_completion = max(self.last_completion, completion)
        return completion

    # -- compaction ----------------------------------------------------------

    def _indexes(self):
        for i, ivs in enumerate(self.rack_intervals):
            yield f"rack {i}", ivs
        yield "wired channel", self.wired_intervals
        for k, ivs in enumerate(self.wireless_intervals):
            yield f"wireless subchannel {k}", ivs

    @property
    def n_intervals(self) -> int:
        """Committed intervals currently retained in the index (excludes
        the ``n_compacted`` already retired)."""
        return sum(len(ivs) for _label, ivs in self._indexes())

    def compact(self, t: float) -> int:
        """Retire every committed interval ending at or before ``t`` from
        the interval index; returns how many were retired.

        Safe whenever ``t`` does not exceed the current epoch: epochs are
        monotone and every later ``channel_busy`` / ``arbitrate`` query
        drops intervals ending at or before its (later) epoch anyway, so
        compaction changes no observable answer — busy-time accumulators
        were charged at commit and holds are untouched. The pending audit
        backlog is flushed first (:meth:`assert_feasible`), so no interval
        is retired unaudited.
        """
        self.assert_feasible()
        t = float(t)
        dropped = 0
        for _label, ivs in self._indexes():
            i = bisect.bisect_right(ivs, t, key=_END)
            if i:
                del ivs[:i]
                dropped += i
        self.n_compacted += dropped
        self.compact_frontier = max(self.compact_frontier, t)
        if self.tracer.enabled:
            self.tracer.event(
                "timeline_compact",
                t=t,
                dropped=dropped,
                retained=self.n_intervals,
            )
            self.tracer.count("intervals_compacted", dropped)
        return dropped

    # -- feasibility audit ---------------------------------------------------

    def assert_feasible(self, tol: float = _EPS, full: bool = False) -> None:
        """Audit the committed timeline: no two committed operations may
        overlap on the same physical resource — tasks on a rack, transfers
        on the wired channel, transfers on one wireless subchannel —
        regardless of which jobs they belong to. Raises ``AssertionError``
        (a real raise, alive under ``python -O``) naming the resource and
        the two owning jobs on the first overlap.

        Incremental by default: only intervals committed since the last
        audit are checked, each against its sorted neighbors in the index
        (disjointness of adjacent pairs is equivalent to global
        disjointness on a start-sorted index). ``full=True`` rescans every
        *retained* interval from scratch — intervals already retired by
        :meth:`compact` were audited before retirement.
        """
        if full:
            self._audit_backlog.clear()
            if self.tracer.enabled:
                self.tracer.event(
                    "timeline_audit", n_checked=self.n_intervals, full=True
                )
            for label, ivs in self._indexes():
                ordered = sorted(ivs)
                for (s0, e0, j0), (s1, _e1, j1) in zip(ordered, ordered[1:]):
                    if s1 < e0 - tol:
                        raise AssertionError(
                            f"{label}: committed intervals of job {j0} "
                            f"[{s0}, {e0}) and job {j1} [{s1}, ...) overlap"
                        )
            return
        backlog, self._audit_backlog = self._audit_backlog, []
        if self.tracer.enabled and backlog:
            self.tracer.event("timeline_audit", n_checked=len(backlog))
            self.tracer.count("intervals_audited", len(backlog))
        for label, ivs, iv in backlog:
            pos = bisect.bisect_left(ivs, iv)
            s, e, j = iv
            if pos > 0:
                s0, e0, j0 = ivs[pos - 1]
                if s < e0 - tol:
                    raise AssertionError(
                        f"{label}: committed intervals of job {j0} "
                        f"[{s0}, {e0}) and job {j} [{s}, ...) overlap"
                    )
            if pos + 1 < len(ivs):
                s1, _e1, j1 = ivs[pos + 1]
                if s1 < e - tol:
                    raise AssertionError(
                        f"{label}: committed intervals of job {j} "
                        f"[{s}, {e}) and job {j1} [{s1}, ...) overlap"
                    )

    # -- metrics -------------------------------------------------------------

    def utilization(self, horizon: float) -> dict[str, float]:
        """Busy-time fractions over ``[0, horizon]``. All three figures are
        exact under the channel-feasible commit model (compaction never
        touches the accumulators) and guaranteed to be true fractions in
        [0, 1]; a fraction outside the float-noise band raises
        ``RuntimeError`` — a real raise, NOT an ``assert``, so the audit
        survives ``python -O`` stripping."""
        if horizon <= 0.0:
            return {"rack": 0.0, "wired": 0.0, "wireless": 0.0}
        util = {
            "rack": self.rack_busy_time / (self.n_racks * horizon),
            "wired": self.wired_busy_time / horizon,
            "wireless": (
                self.wireless_busy_time / (self.n_wireless * horizon)
                if self.n_wireless
                else 0.0
            ),
        }
        for name, frac in util.items():
            if not (-1e-12 <= frac <= 1.0 + 1e-9):
                raise RuntimeError(
                    f"{name} utilization {frac} outside [0, 1]: committed "
                    "timeline is not channel-feasible"
                )
        return {name: min(max(frac, 0.0), 1.0) for name, frac in util.items()}


# -- commit-order replay ------------------------------------------------------
#
# Within one admission epoch the only *shared* resource is the wired
# channel: co-admitted jobs draw disjoint rack and subchannel grants from
# shrinking pools, and every subchannel a job can touch already carries its
# committed intervals in the index (interval-aware grants included). So a
# candidate commit order can be trial-run exactly by accumulating only the
# wired windows earlier trial jobs would commit and feeding them to
# ``arbitrate`` via ``wired_extra`` — no timeline mutation, bit-identical
# to really committing in that order. These helpers are the evaluation side
# of the arbitration-order search in :mod:`repro_torch.core.coflow`.


def wired_windows(
    view: ResidualView, sched: Schedule, t: float
) -> list[tuple[float, float]]:
    """Absolute-time wired-channel transfer windows one commit would add
    (exactly the intervals :meth:`ClusterTimeline.commit` inserts on the
    wired index; zero-size transfers occupy nothing)."""
    inst = view.inst
    if not inst.job.n_edges:
        return []
    dur = inst.duration_on(sched.chan)
    out = []
    for e in range(inst.job.n_edges):
        d = float(dur[e])
        if d > 0.0 and int(sched.chan[e]) == CH_WIRED:
            s = t + float(sched.tstart[e])
            out.append((s, s + d))
    return out


def channel_delay_attribution(
    view: ResidualView, sched: Schedule, placed: Schedule
) -> tuple[float, float]:
    """Split one job's cross-job channel queueing by resource.

    ``placed`` is ``sched`` after :meth:`ClusterTimeline.arbitrate`
    gap-inserted its transfers around other jobs' committed windows;
    arbitration keeps the task->rack and edge->channel decisions, so the
    per-edge start-time slips ``placed.tstart - sched.tstart`` are
    exactly the waiting the shared channels imposed. Returns
    ``(wired_seconds, wireless_seconds)`` — the queueing attribution the
    trace's job-completion marks carry (an uncontended commit returns
    ``(0, 0)`` since arbitrate is the identity there).
    """
    if placed is sched or not view.inst.job.n_edges:
        return 0.0, 0.0
    wired = wireless = 0.0
    for e in range(view.inst.job.n_edges):
        d = float(placed.tstart[e]) - float(sched.tstart[e])
        if d <= 0.0:
            continue
        c = int(placed.chan[e])
        if c == CH_WIRED:
            wired += d
        elif c >= 2:
            wireless += d
    return wired, wireless


def job_holds(
    view: ResidualView, sched: Schedule, t: float
) -> tuple[dict[int, float], dict[int, float]]:
    """Per-physical-resource hold times one commit would take: a
    ``(rack_holds, wireless_holds)`` pair mapping physical id to the
    absolute release time, mirroring :meth:`ClusterTimeline.commit`'s
    hold updates (callers ``max`` them into existing holds)."""
    inst = view.inst
    job = inst.job
    rack_holds: dict[int, float] = {}
    wireless_holds: dict[int, float] = {}
    for i in range(inst.n_racks):
        on_i = sched.rack == i
        if not on_i.any():
            continue
        fin = float(np.max(sched.start[on_i] + job.p[on_i]))
        rack_holds[int(view.rack_map[i])] = t + fin
    if job.n_edges:
        dur = inst.duration_on(sched.chan)
        for e in range(job.n_edges):
            c, d = int(sched.chan[e]), float(dur[e])
            if d <= 0.0 or c < 2:
                continue
            phys = int(view.wireless_map[c - 2])
            end = t + float(sched.tstart[e]) + d
            if end > wireless_holds.get(phys, -np.inf):
                wireless_holds[phys] = end
    return rack_holds, wireless_holds


def reservation_backfill_safe(
    rack_hold: np.ndarray,
    wireless_hold: np.ndarray,
    n_racks_granted: int,
    n_wireless_granted: int,
    completion: float,
    t: float,
    hol_need: tuple[int, int],
) -> bool:
    """Prove (or refuse) that a backfill commit cannot delay the blocked
    head-of-line job's admission epoch, from the hold vectors alone.

    The head job's *reservation* is the earliest time its needed racks and
    subchannels can all be free given ``rack_hold`` / ``wireless_hold``.
    The commit is safe when either the candidate's post-arbitration
    ``completion`` lands at or before the reservation (every hold a job
    takes is released by its completion, so everything the candidate
    touches is free again in time), or — shadow slack — the reservation
    time keeps enough free racks/subchannels for the head job even with
    the candidate's grant removed for good. Pure function of the hold
    vectors so the service's live commits and
    :func:`replay_commit_order`'s trial commits run the *same* proof
    (the service method delegates here).
    """
    need_r, need_w = hol_need
    t_res = max(t, float(np.sort(rack_hold)[need_r - 1]))
    if need_w:
        t_res = max(t_res, float(np.sort(wireless_hold)[need_w - 1]))
    if completion <= t_res:
        return True
    free_r = int(np.sum(rack_hold <= t_res))
    if free_r - n_racks_granted < need_r:
        return False
    if need_w:
        free_w = int(np.sum(wireless_hold <= t_res))
        if free_w - n_wireless_granted < need_w:
            return False
    return True


@dataclasses.dataclass(frozen=True)
class OrderReplay:
    """Outcome of trial-committing one epoch batch in one candidate order.

    ``placed`` / ``completions`` are indexed by *batch position* (not
    commit rank); a position is ``None`` when the trial's backfill proof
    rejected that candidate (it would stay queued). ``objective`` is the
    lexicographic figure the order search minimizes: reject as few
    backfill candidates as possible, then minimize the batch's total
    arrival-to-completion time. ``n_deadline_missed`` counts trial
    commits whose completion overran the job's deadline (positions with
    ``deadlines[pos] is None`` and rejected positions never count); the
    admission oracle in ``tests/test_admission.py`` compares candidate
    admission orders on it.
    """

    order: tuple[int, ...]
    placed: list
    completions: list
    n_rejected: int
    total_jct: float
    n_deadline_missed: int = 0

    @property
    def objective(self) -> tuple[int, float]:
        return (self.n_rejected, self.total_jct)


def replay_commit_order(
    cluster: ClusterTimeline,
    t: float,
    views: list[ResidualView],
    order,
    *,
    scheds: list[Schedule] | None = None,
    solver=None,
    arrivals: list[float] | None = None,
    is_backfill: list[bool] | None = None,
    hol_need: tuple[int, int] | None = None,
    deadlines: "list[float | None] | None" = None,
) -> OrderReplay:
    """Trial-run one commit permutation of an epoch batch, mutating nothing.

    Mirrors the service's commit loop exactly: jobs are arbitrated in
    ``order`` (each seeing the wired windows of every earlier trial
    commit via ``wired_extra``), and backfill candidates run the same
    reservation/shadow-slack proof on trial copies of the hold vectors —
    so really committing in ``order`` afterwards produces bit-identical
    schedules, completions, and backfill decisions.

    Exactly one of ``scheds`` (pre-solved schedules, the fleet policy) or
    ``solver`` (``solver(view, busy) -> Schedule``, lazy baselines whose
    placement depends on the busy intervals seen) must be given.
    ``arrivals`` (defaults to ``t``) weight each job's completion into
    ``total_jct``; ``deadlines`` (per batch position, ``None`` entries =
    best-effort) feeds :attr:`OrderReplay.n_deadline_missed`.
    """
    n = len(views)
    if (scheds is None) == (solver is None):
        raise ValueError("pass exactly one of scheds= or solver=")
    order = tuple(int(i) for i in order)
    if sorted(order) != list(range(n)):
        raise ValueError(f"order {order} is not a permutation of range({n})")
    arr = [float(t)] * n if arrivals is None else [float(a) for a in arrivals]
    bf = [False] * n if is_backfill is None else list(is_backfill)
    need_holds = any(bf)
    rack_hold = cluster.rack_hold.copy() if need_holds else None
    wireless_hold = cluster.wireless_hold.copy() if need_holds else None
    wired_extra: list[tuple[float, float]] = []
    ddl = [None] * n if deadlines is None else list(deadlines)
    if len(ddl) != n:
        raise ValueError("deadlines must match views in length")
    placed_out: list = [None] * n
    completions: list = [None] * n
    n_rejected = 0
    n_deadline_missed = 0
    total_jct = 0.0
    for pos in order:
        view = views[pos]
        if solver is not None:
            busy = cluster.channel_busy(view, t, wired_extra=wired_extra)
            placed = solver(view, busy)
        else:
            placed = cluster.arbitrate(view, scheds[pos], t, wired_extra=wired_extra)
        comp = t + float(placed.makespan)
        if bf[pos] and not reservation_backfill_safe(
            rack_hold,
            wireless_hold,
            view.inst.n_racks,
            view.inst.n_wireless,
            comp,
            t,
            hol_need,
        ):
            n_rejected += 1
            continue
        placed_out[pos] = placed
        completions[pos] = comp
        total_jct += comp - arr[pos]
        if ddl[pos] is not None and comp > ddl[pos]:
            n_deadline_missed += 1
        wired_extra.extend(wired_windows(view, placed, t))
        if need_holds:
            r_holds, w_holds = job_holds(view, placed, t)
            for phys, h in r_holds.items():
                if h > rack_hold[phys]:
                    rack_hold[phys] = h
            for phys, h in w_holds.items():
                if h > wireless_hold[phys]:
                    wireless_hold[phys] = h
    return OrderReplay(
        order, placed_out, completions, n_rejected, total_jct, n_deadline_missed
    )
