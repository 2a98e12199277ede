# Copied from src/repro/online/metrics.py; imports retargeted to repro_torch.
"""Per-job and aggregate metrics for the online scheduling service.

The figures of merit of the paper's production claim (§V, ~10% JCT
reduction) are *arrival-to-completion* job completion times, not solver
makespans: a job's JCT includes the time it queued for resources. This
module defines the per-job record (:class:`JobMetrics`), the aggregate
(:class:`OnlineResult`) the service returns — mean/percentile JCT,
queueing delay, cluster utilization, service makespan, and the scheduler
throughput / candidate counters used by the serving benchmarks — and
:class:`StreamingSeries`, the O(1)-memory quantile sketch the service
feeds per completion so 100k-job runs never materialize a JCT array.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

if typing.TYPE_CHECKING:  # pragma: no cover - type-only import
    from repro_torch.online.cluster import ClusterTimeline

__all__ = ["JobMetrics", "OnlineResult", "StreamingSeries"]


class _P2Quantile:
    """Jain & Chlamtac's P-squared estimator for one quantile.

    Five markers track (min, two intermediates, the target quantile, max);
    each observation shifts marker positions and parabolically adjusts the
    heights, so the estimate is O(1) memory and O(1) per observation.
    Callers must seed it with exactly five observations (any order).
    """

    __slots__ = ("p", "q", "n", "np_", "dn")

    def __init__(self, p: float, first5: typing.Sequence[float]):
        if len(first5) != 5:
            raise ValueError("P2 estimator must be seeded with 5 samples")
        self.p = float(p)
        self.q = sorted(float(x) for x in first5)
        self.n = [0.0, 1.0, 2.0, 3.0, 4.0]
        self.np_ = [0.0, 2 * p, 4 * p, 2 + 2 * p, 4.0]
        self.dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]

    def add(self, x: float) -> None:
        q, n = self.q, self.n
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while x >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self.np_[i] += self.dn[i]
        for i in (1, 2, 3):
            d = self.np_[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or (
                d <= -1.0 and n[i - 1] - n[i] < -1.0
            ):
                d = 1.0 if d > 0 else -1.0
                qp = self._parabolic(i, d)
                if not q[i - 1] < qp < q[i + 1]:
                    qp = self._linear(i, d)
                q[i] = qp
                n[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self.q, self.n
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        j = i + int(d)
        return self.q[i] + d * (self.q[j] - self.q[i]) / (self.n[j] - self.n[i])

    @property
    def value(self) -> float:
        return self.q[2]


class StreamingSeries:
    """Streaming scalar summary: count/mean/min/max plus quantile sketches.

    Exact while small, sketched at scale: the first ``exact_max``
    observations are buffered and quantiles answered exactly
    (``np.percentile`` semantics); past that the buffer is replayed into
    one P-squared estimator per tracked quantile and dropped, after which
    memory is O(1) regardless of stream length. The replay preserves
    arrival order, so the sketch state is identical to having streamed
    from the first observation.
    """

    __slots__ = ("quantiles", "count", "_sum", "_min", "_max", "_exact",
                 "_exact_max", "_sketches")

    # p95 rides along so OnlineResult.p95_jct stays answerable at scale.
    DEFAULT_QUANTILES = (0.50, 0.90, 0.95, 0.99)

    def __init__(
        self,
        quantiles: typing.Sequence[float] = DEFAULT_QUANTILES,
        *,
        exact_max: int = 64,
    ):
        if exact_max < 5:
            raise ValueError("exact_max must be >= 5 to seed the sketches")
        for p in quantiles:
            if not 0.0 < p < 1.0:
                raise ValueError(f"quantile {p} not in (0, 1)")
        self.quantiles = tuple(float(p) for p in quantiles)
        self.count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._exact: list[float] | None = []
        self._exact_max = int(exact_max)
        self._sketches: dict[float, _P2Quantile] | None = None

    def push(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self._sum += x
        if x < self._min:
            self._min = x
        if x > self._max:
            self._max = x
        if self._exact is not None:
            self._exact.append(x)
            if len(self._exact) > self._exact_max:
                buf, self._exact = self._exact, None
                self._sketches = {
                    p: _P2Quantile(p, buf[:5]) for p in self.quantiles
                }
                for v in buf[5:]:
                    for sk in self._sketches.values():
                        sk.add(v)
        else:
            assert self._sketches is not None
            for sk in self._sketches.values():
                sk.add(x)

    # Zero-sample semantics: every statistic of an empty stream is NaN,
    # not 0.0 — a serve with no completions has *no* p99, and rendering
    # it as 0 would read as "instant". Renderers (OnlineResult.summary,
    # the Prometheus exposition) detect NaN and print "n/a" / omit the
    # quantile lines instead.

    @property
    def mean(self) -> float:
        return self._sum / self.count if self.count else float("nan")

    @property
    def max(self) -> float:
        return self._max if self.count else float("nan")

    @property
    def min(self) -> float:
        return self._min if self.count else float("nan")

    def quantile(self, p: float) -> float:
        """Estimated ``p``-quantile (exact while the buffer is alive).

        NaN when no samples have been observed (see class note above).
        """
        if not self.count:
            return float("nan")
        if self._exact is not None:
            return float(np.percentile(self._exact, 100.0 * p))
        sketches = self._sketches
        assert sketches is not None
        if p not in sketches:
            raise KeyError(
                f"quantile {p} not tracked (tracked: {self.quantiles}); "
                "construct the series with it in `quantiles`"
            )
        # P² safety clamp. Right after the exact->sketch switch the
        # estimator has seen only a handful of post-seed samples, and the
        # parabolic marker adjustment can place the target marker anywhere
        # between its neighbors — for extreme quantiles that is a poor
        # (though finite) estimate; with non-finite inputs the marker
        # heights can be poisoned into NaN outright. Any quantile of the
        # observed stream lies in [min, max] by definition, so clamp the
        # sketch value into the exact observed range and fall back to the
        # nearest observed extreme when the sketch state is not finite —
        # percentile accessors then never return NaN or an out-of-range
        # value, no matter how few samples arrived past the boundary.
        v = float(sketches[p].value)
        if not np.isfinite(v):
            v = self._max if p >= 0.5 else self._min
        return float(min(max(v, self._min), self._max))

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p90(self) -> float:
        return self.quantile(0.90)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        mode = "exact" if self._exact is not None else "p2"
        return (
            f"StreamingSeries(n={self.count}, mean={self.mean:.3g}, "
            f"p50={self.p50:.3g}, p90={self.p90:.3g}, p99={self.p99:.3g}, "
            f"mode={mode})"
        )


@dataclasses.dataclass(frozen=True)
class JobMetrics:
    """Lifecycle record of one served job.

    Attributes:
      job_id: stream position (matches the :class:`ArrivalEvent`).
      family: workload family tag.
      arrival: absolute arrival time.
      admitted: absolute admission epoch (start of execution).
      completion: absolute completion time.
      makespan: the committed (channel-arbitrated) schedule's makespan —
        the job's true execution time on the shared cluster, so
        ``completion == admitted + makespan`` always.
      n_racks_granted / n_wireless_granted: residual shape the job ran on
        (may be below its demand under contention).
      n_solves: solver invocations for this job (1 + re-optimizations
        while queued; 1 for baseline policies).
      solver_makespan: the served schedule's makespan as the solver saw it
        (private resource view, before cross-job arbitration); the gap
        ``makespan - solver_makespan`` is the job's cross-job channel
        queueing.
      backfilled: True when the job overtook a blocked head-of-line job
        under the service's backfilling admission mode.
      assignment: int64[n_tasks] committed task->rack assignment in
        *physical* rack ids (the residual view's local labels mapped
        through its rack grant).
      deadline / tenant / tier: SLO metadata copied from the
        :class:`~repro_torch.online.workload.ArrivalEvent` (``None`` for
        untiered streams).
      n_overtaken: admissions of *later-arriving* jobs that jumped ahead
        of this job while it queued (non-FIFO admission orders and
        backfilling both count); bounded by the service's
        ``max_overtakes`` knob when set.
    """

    job_id: int
    family: str
    arrival: float
    admitted: float
    completion: float
    makespan: float
    n_racks_granted: int
    n_wireless_granted: int
    n_solves: int
    solver_makespan: float = float("nan")
    backfilled: bool = False
    assignment: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )
    deadline: float | None = None
    tenant: str | None = None
    tier: str | None = None
    n_overtaken: int = 0

    @property
    def queueing_delay(self) -> float:
        """Time spent waiting for admission (``admitted - arrival``)."""
        return self.admitted - self.arrival

    @property
    def jct(self) -> float:
        """Arrival-to-completion time (``completion - arrival``)."""
        return self.completion - self.arrival

    @property
    def deadline_missed(self) -> bool:
        """True when the job had a deadline and completed after it."""
        return self.deadline is not None and self.completion > self.deadline


@dataclasses.dataclass
class OnlineResult:
    """Outcome of serving one arrival stream.

    Attributes:
      jobs: one :class:`JobMetrics` per served job, in ``job_id`` order.
      policy: scheduling policy name (``"fleet"`` or an online baseline).
      warm_start: whether queued-job re-optimization was warm-started.
      n_epochs: admission epochs the event loop processed.
      n_batches: ``schedule_fleet`` mega-batch launches (0 for baselines).
      n_solves: solver invocations summed over jobs (admission solves plus
        planning re-optimizations of queued jobs).
      n_candidates / n_pruned: fleet-engine candidate counters summed over
        every solve (0 for baseline policies).
      solver_wall: wall-clock seconds spent inside the per-epoch solvers.
      horizon: last completion time (the service makespan).
      rack_utilization / wired_utilization / wireless_utilization:
        busy-time fractions of the cluster over ``[0, horizon]``; all
        three are true fractions in [0, 1] under channel-feasible commits.
      n_backfilled: jobs admitted by overtaking a blocked head-of-line job
        (0 unless the service runs with ``backfill=True``).
      n_backfill_rejected: overtake candidates whose commit was refused
        because arbitration could not prove them harmless (their
        post-arbitration completion overran the head-of-line
        reservation); each rejection left the candidate queued.
      timeline: the committed :class:`~repro_torch.online.cluster
        .ClusterTimeline` (audited feasible by the service before it
        returns) — kept for post-hoc inspection and the test-suite
        feasibility audit.
      queue_stats / jct_stats: per-completion :class:`StreamingSeries`
        over queueing delays and JCTs (``None`` when the result was built
        without streaming stats, e.g. hand-constructed in tests); the
        percentile properties below fall back to the ``jobs`` list.
      peak_active: maximum number of jobs executing concurrently.
      peak_queue_depth: maximum number of jobs queued (arrived, not yet
        admitted) at any epoch.
      n_served: jobs served — equals ``len(jobs)`` unless the service ran
        with ``record_jobs=False``, in which case ``jobs`` is empty and
        this counter is the only cardinality record.
      epoch_commit_latency: per-epoch wall seconds of the
        arbitrate-and-commit stage (populated only under
        ``track_epoch_latency=True``; the stress lane's flat-latency
        check reads it).
      arbitration: cross-job commit-order policy the service ran
        (``"fifo"`` / ``"sigma"`` / ``"search"``).
      n_order_evals: unique commit orders trial-replayed by the
        arbitration-order search across all epochs (0 under FIFO).
      n_epochs_reordered: epochs whose committed order differed from
        queue order.
      arbitration_gain: summed per-epoch replayed total-JCT delta of the
        committed order vs FIFO (positive = the reordering improved the
        batch; sigma commits its order unconditionally, so its gain can
        go negative).
      admission: queue-ordering policy the service ran (``"fifo"`` /
        ``"edf"`` / ``"wfair"``).
      n_deadline_jobs: served jobs that carried a deadline.
      n_deadline_missed: served deadline jobs that completed after it.
      n_deadline_deferrals: commits postponed by ``admission_control=
        "defer"`` because the replayed trial proved the post-arbitration
        completion would overrun the deadline (each deferral left the job
        queued for a later epoch).
      n_deadline_rejected: jobs dropped by ``admission_control="reject"``
        on the rigorous lower-bound proof ``now + lower_bound(inst) >
        deadline`` (never served; ids in ``rejected_job_ids``, no
        :class:`JobMetrics` row, excluded from JCT aggregates).
      rejected_job_ids: stream ids of the rejected jobs, in rejection
        order.
      tier_slo: per-tier ``(n_met, n_deadline_jobs)`` pairs over served
        deadline-carrying jobs (see :attr:`slo_attainment`).
      tenant_queue_stats: per-tenant :class:`StreamingSeries` of queueing
        delays (feeds :attr:`tenant_p99_queueing_delay`).
      max_overtakes_observed: largest per-job overtake count; when the
        service ran with a ``max_overtakes`` bound this is asserted
        ``<= max_overtakes`` before ``serve`` returns.
      n_reconfigs: wireless subchannels reconfigured by the per-epoch
        matching (0 unless the service ran with ``topology="matching"``).
      n_link_events: link outage/repair events applied from the outage
        trace (0 without one).
    """

    jobs: list[JobMetrics]
    policy: str
    warm_start: bool
    n_epochs: int
    n_batches: int
    n_solves: int
    n_candidates: int
    n_pruned: int
    solver_wall: float
    horizon: float
    rack_utilization: float
    wired_utilization: float
    wireless_utilization: float
    n_backfilled: int = 0
    n_backfill_rejected: int = 0
    timeline: "ClusterTimeline | None" = None
    queue_stats: StreamingSeries | None = None
    jct_stats: StreamingSeries | None = None
    peak_active: int = 0
    peak_queue_depth: int = 0
    n_served: int = 0
    epoch_commit_latency: "list[float] | None" = None
    arbitration: str = "fifo"
    n_order_evals: int = 0
    n_epochs_reordered: int = 0
    arbitration_gain: float = 0.0
    admission: str = "fifo"
    n_deadline_jobs: int = 0
    n_deadline_missed: int = 0
    n_deadline_deferrals: int = 0
    n_deadline_rejected: int = 0
    rejected_job_ids: list[int] = dataclasses.field(default_factory=list)
    tier_slo: "dict[str, tuple[int, int]]" = dataclasses.field(
        default_factory=dict
    )
    tenant_queue_stats: "dict[str, StreamingSeries]" = dataclasses.field(
        default_factory=dict
    )
    max_overtakes_observed: int = 0
    n_reconfigs: int = 0
    n_link_events: int = 0

    @property
    def slo_attainment(self) -> "dict[str, float]":
        """Per-tier fraction of deadline-carrying jobs that met their SLO.

        Tiers with no deadline-carrying served jobs (e.g. best-effort
        tiers) are omitted rather than reported as 0 or 1.
        """
        return {
            tier: met / total
            for tier, (met, total) in sorted(self.tier_slo.items())
            if total
        }

    @property
    def tenant_p99_queueing_delay(self) -> "dict[str, float]":
        """Per-tenant p99 queueing delay (from the streaming sketches)."""
        return {
            tenant: s.p99
            for tenant, s in sorted(self.tenant_queue_stats.items())
            if s.count
        }

    @property
    def jcts(self) -> np.ndarray:
        return np.asarray([j.jct for j in self.jobs], dtype=np.float64)

    @property
    def queueing_delays(self) -> np.ndarray:
        return np.asarray([j.queueing_delay for j in self.jobs], dtype=np.float64)

    # Empty-serve semantics mirror StreamingSeries: a result with no
    # served jobs has NaN aggregates (there is no mean JCT of nothing),
    # and summary() renders them as "n/a".

    @property
    def mean_jct(self) -> float:
        if self.jobs:
            return float(self.jcts.mean())
        return self.jct_stats.mean if self.jct_stats is not None else float("nan")

    @property
    def p95_jct(self) -> float:
        if self.jobs:
            return float(np.percentile(self.jcts, 95))
        if self.jct_stats is not None:
            return self.jct_stats.quantile(0.95)
        return float("nan")

    @property
    def mean_queueing_delay(self) -> float:
        if self.jobs:
            return float(self.queueing_delays.mean())
        return (
            self.queue_stats.mean
            if self.queue_stats is not None
            else float("nan")
        )

    @property
    def makespan(self) -> float:
        """Service makespan: last completion (== ``horizon``)."""
        return self.horizon

    @property
    def n_jobs(self) -> int:
        """Served-job count, valid even when per-job records were elided."""
        return max(len(self.jobs), self.n_served)

    def _quantile(self, stats: StreamingSeries | None, values, p: float) -> float:
        if stats is not None and stats.count:
            return stats.quantile(p)
        if len(values):
            return float(np.percentile(values, 100.0 * p))
        return float("nan")

    @property
    def p50_queueing_delay(self) -> float:
        return self._quantile(self.queue_stats, self.queueing_delays, 0.50)

    @property
    def p90_queueing_delay(self) -> float:
        return self._quantile(self.queue_stats, self.queueing_delays, 0.90)

    @property
    def p99_queueing_delay(self) -> float:
        return self._quantile(self.queue_stats, self.queueing_delays, 0.99)

    @property
    def p50_jct(self) -> float:
        return self._quantile(self.jct_stats, self.jcts, 0.50)

    @property
    def p90_jct(self) -> float:
        return self._quantile(self.jct_stats, self.jcts, 0.90)

    @property
    def p99_jct(self) -> float:
        return self._quantile(self.jct_stats, self.jcts, 0.99)

    @property
    def jobs_per_solver_second(self) -> float:
        """Scheduler throughput: served jobs per second of solver wall time.

        A zero-cost policy (e.g. a heuristic baseline whose per-job wall
        time is below timer resolution) has *infinite* throughput, not
        zero — returned as ``inf`` so benchmark tables sort it above, not
        below, every engine configuration. An empty result is 0.0.
        """
        if self.solver_wall > 0:
            return len(self.jobs) / self.solver_wall
        return float("inf") if self.jobs else 0.0

    def summary(self) -> str:
        """One-line human summary (used by the example and benchmarks).

        NaN aggregates (empty serve: 0 arrivals or an all-rejected
        stream) render as ``n/a`` rather than ``nan``/``0.0``.
        """

        def f1(v: float) -> str:
            return f"{v:.1f}" if np.isfinite(v) else "n/a"

        jps = self.jobs_per_solver_second
        jps_s = f"{jps:.2f}" if np.isfinite(jps) else "inf"
        arb = (
            f"arb={self.arbitration} reordered={self.n_epochs_reordered} "
            f"gain={self.arbitration_gain:.1f} "
            if self.arbitration != "fifo"
            else ""
        )
        adm = ""
        if (
            self.admission != "fifo"
            or self.n_deadline_jobs
            or self.n_deadline_rejected
        ):
            adm = (
                f"adm={self.admission} "
                f"misses={self.n_deadline_missed}/{self.n_deadline_jobs} "
            )
            slo = self.slo_attainment
            if slo:
                adm += (
                    "slo("
                    + ",".join(f"{t}={v:.2f}" for t, v in slo.items())
                    + ") "
                )
            if self.n_deadline_deferrals:
                adm += f"deferrals={self.n_deadline_deferrals} "
            if self.n_deadline_rejected:
                adm += f"rejected={self.n_deadline_rejected} "
            if self.max_overtakes_observed:
                adm += f"max_overtaken={self.max_overtakes_observed} "
            p99q = self.tenant_p99_queueing_delay
            if p99q:
                adm += (
                    "tenant_p99q("
                    + ",".join(f"{t}={v:.1f}" for t, v in p99q.items())
                    + ") "
                )
        return (
            f"policy={self.policy} warm={self.warm_start} jobs={self.n_jobs} "
            f"mean_jct={f1(self.mean_jct)} p95_jct={f1(self.p95_jct)} "
            f"mean_queue={f1(self.mean_queueing_delay)} "
            f"queue_p50/p90/p99={f1(self.p50_queueing_delay)}/"
            f"{f1(self.p90_queueing_delay)}/{f1(self.p99_queueing_delay)} "
            f"jct_p50/p90/p99={f1(self.p50_jct)}/{f1(self.p90_jct)}/"
            f"{f1(self.p99_jct)} "
            f"peak_active={self.peak_active} peak_queue={self.peak_queue_depth} "
            f"makespan={self.makespan:.1f} "
            f"util(rack/wired/wireless)="
            f"{self.rack_utilization:.2f}/{self.wired_utilization:.2f}/"
            f"{self.wireless_utilization:.2f} "
            f"epochs={self.n_epochs} solves={self.n_solves} "
            f"{arb}"
            f"{adm}"
            f"backfilled={self.n_backfilled} "
            f"pruned={self.n_pruned}/{self.n_candidates} "
            f"jobs_per_solver_s={jps_s} solver_wall={self.solver_wall:.2f}s"
        )
