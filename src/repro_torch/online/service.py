# Copied from src/repro/online/service.py; imports retargeted to repro_torch.
"""Arrival-driven scheduling service: a three-stage epoch pipeline over the
fleet engine with warm-started re-optimization.

Each admission epoch runs the same pipeline:

  1. **Collect** (:meth:`OnlineScheduler._collect_arrivals`). Arrivals are
     pulled from a lazily consumed stream (any iterator of time-sorted
     :class:`~repro_torch.online.workload.ArrivalEvent`; a plain list is sorted
     and wrapped) and batched into the epoch — the first unserved arrival
     opens a window of length ``window``; every job arriving inside it
     joins the epoch's batch. Completions due at the epoch wake the loop
     and release their grants back into the incrementally maintained
     free-rack/subchannel sets (delta-updates on grant/release instead of
     per-epoch ``np.nonzero`` rebuilds over all holds).
  2. **Plan** (:meth:`OnlineScheduler._plan_batch`). Admission selection
     draws residual views from shrinking per-epoch pools so co-admitted
     jobs' grants are disjoint, then all admission and planning solves of
     the epoch launch as ONE ``schedule_fleet`` mega-batch: the lockstep
     driver and the fused §IV-A stage-1 pruner are shared across the
     batch, each job's ``OpTables`` (built once at first solve, cached on
     the queue entry) skip the per-launch rebuild, and compiled programs
     are reused across epochs — fleets in the same size bucket retrace
     nothing, so steady state launches with zero retraces.
  3. **Arbitrate & commit** (:meth:`OnlineScheduler._arbitrate_and_commit`).
     Every commit — fleet policy and baselines alike — passes through the
     timeline's cross-job arbitration pass, which sequences the job's
     transfers around the busy intervals already committed on its
     physical channels (the shared wired channel above all) by replaying
     the schedule through the host simulator; committed timelines are
     audited channel-feasible before ``serve`` returns. Committed grants
     are pushed into the free sets and per-completion streaming stats
     (p50/p90/p99 queueing delay and JCT, peak gauges), and — with
     ``compact_interval > 0`` — the timeline's interval index is
     periodically compacted so steady-state cost depends only on *active*
     jobs, not the full arrival history (observationally identical;
     locked by ``tests/test_online_scale.py``).

  2b. **Backfilling** (``backfill=True``, an extension of
     ``preserve_order``): when the head-of-line job is blocked, a later
     queued job may overtake it only when arbitration *proves* it cannot
     delay the head-of-line admission — either the candidate's
     post-arbitration completion lands by the head job's resource
     reservation (the earliest time its demanded racks/subchannels can
     all be free, so everything the candidate touches is released again
     in time), or, shadow slack, the reservation keeps enough free
     resources for the head job even with the candidate's grant removed
     for good. A candidate that cannot prove either stays queued (its
     solve still feeds the warm-start incumbents).

  **Warm-started re-optimization.** A job that cannot be admitted
  (no free rack, or fewer than ``min_free_racks``) stays queued, but is
  still *planned* in the epoch's mega-batch against its full demanded
  shape. With ``warm_start=True`` each planning solve (and the eventual
  admission solve) seeds the engine's sweep with the job's incumbent
  assignments via the ``seed_pools`` hook — budget-neutral (seeds
  displace an equal number of random samples), so warm vs cold is an
  equal-candidate-budget comparison, and since seeds are themselves
  evaluated, a warm re-solve can never return a worse assignment than
  its own incumbent's greedy score.

Determinism: with a fixed ``seed`` and a fixed arrival stream the service
is bit-reproducible. Engine seeds follow a common-random-numbers
discipline (the standard variance-reduction tool for comparing policies
on one trace): a job's *admission* solve always uses
``seed + 1009 * job_id``, while *planning* re-solves of a queued job add
``9173 * n_prior_solves`` so each re-optimization explores fresh samples.
Consequence: a cold-start arm's committed result for job ``j`` is the
deterministic unseeded solve ``R_j`` (its admission solve ignores queue
history), and a warm arm's chain *starts* at exactly ``R_j`` (the first
solve has no incumbents yet and shares its seed) — so keep-incumbent
re-optimization makes the warm arm's served *solver* makespan provably
<= the cold arm's for every job whose admitted shape matches its
planning shape (e.g. under ``require_full_demand``). The post-arbitration
completion additionally depends on the other jobs sharing the physical
channels, so the per-job guarantee is on the served schedule, not on the
cross-job channel queueing around it.

Degenerate reduction (locked by ``tests/test_online.py``): with every job
arriving at t=0, ``window=0``, an empty cluster granting every job its
full demanded shape, and no cross-job traffic on the shared wired
channel, the single epoch's batch is exactly a direct ``schedule_fleet``
call — per-job assignments and JCTs are bit-for-bit identical.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import time as _time
from collections.abc import Sequence as _SequenceABC
from typing import Iterable, Iterator, Sequence

import numpy as np

from repro_torch.core.baselines import ONLINE_BASELINES
from repro_torch.core.bounds import lower_bound
from repro_torch.core.coflow import (
    coflow_from_instance,
    coflow_from_schedule,
    search_commit_order,
    sigma_order,
)
from repro_torch.core.schedule import Schedule
from repro_torch.core.simulator import OpTables, build_op_tables
from repro_torch.core.vectorized import schedule_fleet
from repro_torch.online.cluster import (
    ClusterTimeline,
    ResidualView,
    channel_delay_attribution,
    replay_commit_order,
    reservation_backfill_safe,
)
from repro_torch.core.instance import Topology
from repro_torch.online.metrics import JobMetrics, OnlineResult, StreamingSeries
from repro_torch.online.workload import ArrivalEvent, LinkEvent
from repro_torch.device import resolve_device
from repro_torch.obs.trace import as_tracer

__all__ = ["OnlineScheduler", "DEFAULT_SOLVER_KWARGS"]

# Engine budget per epoch solve. Deliberately lighter than the offline
# defaults: a serving epoch re-optimizes often, so per-solve budget trades
# against responsiveness. Benchmarks override freely.
DEFAULT_SOLVER_KWARGS = dict(
    max_enumerate=2_000,
    n_samples=512,
    batch_size=512,
    refine_rounds=2,
    refine_pool=256,
)


def _shape_key(inst) -> tuple:
    """Resource-shape fingerprint an incumbent schedule is valid for.

    A stored schedule replays only against a view with the same rack /
    subchannel counts AND the same induced topology mask — under a
    reconfigurable topology a channel pick that was feasible last epoch
    may be unreachable now. An all-ones mask never restricts a pick, so
    it fingerprints identically to ``topology=None``: queued planning
    solves run on the topology-free full-demand instance, and their
    incumbents must stay commit-eligible on an unrestricted view (this is
    what keeps the static all-ones serve bit-identical to pre-topology).
    """
    key: tuple = (inst.n_racks, inst.n_wireless)
    if inst.topology is not None and not inst.topology.is_all_ones:
        key += (inst.topology.reach.tobytes(),)
    return key


@dataclasses.dataclass(eq=False)
class _PendingJob:
    """Queue entry: one arrived, not-yet-admitted job.

    Identity equality (``eq=False``): queue membership is by object, and
    the generated field-wise ``__eq__`` would compare nested numpy arrays
    (ambiguous truth value) the moment ``list.remove`` scans past a
    *different* entry with an equal arrival time — which reordered
    commits do routinely.
    """

    event: ArrivalEvent
    n_solves: int = 0
    # Distinct incumbent assignments from prior solves, best-first
    # (labels in the shape of the solve that produced them; the seed-pool
    # hook folds them into the residual shape with a modulo).
    incumbents: list[np.ndarray] = dataclasses.field(default_factory=list)
    # Best *simulated* schedule over the job's solve chain, with the
    # resource shape it was solved for: a warm admission commits this
    # incumbent schedule when the fresh re-solve fails to beat it (and
    # the admitted shape matches), making the served makespan monotone
    # over re-optimizations.
    best_sched: Schedule | None = None
    best_makespan: float = np.inf
    best_shape: tuple | None = None  # _shape_key of the producing solve
    # Simulator op tables for this job, built on first solve and reused
    # across every re-optimization epoch (tables depend only on the job's
    # DAG, so one build serves full-demand and residual shapes alike).
    op_tables: OpTables | None = None
    # Free-capacity fingerprint at the job's last planning solve; the
    # bounded re-plan mode skips re-solving while it is unchanged.
    view_sig: tuple | None = None
    # SLO admission state: how many later-arriving jobs were admitted
    # ahead of this one (bounded by ``max_overtakes`` when set), the
    # cached rigorous lower bound backing the rejection proof, and the
    # defer-mode flag that stops protecting a provably unmeetable
    # deadline (the job then serves ASAP and the miss is counted).
    n_overtaken: int = 0
    lb: float | None = None
    hopeless: bool = False

    def tables(self) -> OpTables:
        if self.op_tables is None:
            self.op_tables = build_op_tables(self.event.inst)
        return self.op_tables

    def remember(self, res, shape: tuple, cap: int) -> None:
        assignment = np.asarray(res.best_assignment, dtype=np.int64)
        key = assignment.tobytes()
        self.incumbents = [a for a in self.incumbents if a.tobytes() != key]
        self.incumbents.insert(0, assignment.copy())
        del self.incumbents[cap:]
        # A shape change invalidates the stored schedule (it was feasible
        # only for the old resource view); same-shape solves keep the min.
        if shape != self.best_shape or res.makespan < self.best_makespan:
            self.best_sched = res.schedule
            self.best_makespan = float(res.makespan)
            self.best_shape = shape


class _ArrivalStream:
    """Pull-based arrival source consumed one event at a time.

    A materialized ``Sequence`` is sorted by ``(time, job_id)`` exactly as
    the pre-pipeline loop did; any other iterable is treated as a lazy
    stream and must already be time-sorted (enforced event by event), so
    100k-arrival traces flow through the service without ever
    materializing.
    """

    __slots__ = ("_it", "_next", "_last_time")

    def __init__(self, arrivals: Iterable[ArrivalEvent]):
        if isinstance(arrivals, _SequenceABC):
            self._it: Iterator[ArrivalEvent] = iter(
                sorted(arrivals, key=lambda e: (e.time, e.job_id))
            )
        else:
            self._it = iter(arrivals)
        self._next: ArrivalEvent | None = None
        self._last_time = -np.inf
        self._advance()

    def _advance(self) -> None:
        self._next = next(self._it, None)
        if self._next is not None:
            if self._next.time < self._last_time:
                raise ValueError(
                    "streaming arrivals must be sorted by time "
                    f"(saw {self._next.time} after {self._last_time})"
                )
            self._last_time = self._next.time

    @property
    def exhausted(self) -> bool:
        return self._next is None

    def peek_time(self) -> float:
        return self._next.time if self._next is not None else np.inf

    def pop(self) -> ArrivalEvent:
        ev = self._next
        assert ev is not None
        self._advance()
        return ev


class _FreeSet:
    """Incrementally maintained set of free resource ids.

    Mirrors ``np.nonzero(hold <= t)[0]`` without re-scanning the hold
    vector every epoch: ``grant`` removes an id and records its release time
    in a min-heap; ``advance`` pops due releases and re-checks the *live*
    hold (a later commit may have extended it — the stale heap entry is
    then re-pushed at the real hold, so entries are self-correcting). The
    id list stays sorted, so ``as_array()`` is bit-identical to the
    ``np.nonzero`` scan at every epoch.
    """

    __slots__ = ("ids", "_members", "_releases")

    def __init__(self, n: int):
        self.ids: list[int] = list(range(n))
        self._members = set(self.ids)
        self._releases: list[tuple[float, int]] = []

    def advance(self, t: float, hold: np.ndarray) -> None:
        rel = self._releases
        while rel and rel[0][0] <= t:
            _, i = heapq.heappop(rel)
            if i in self._members:
                continue
            h = float(hold[i])
            if h <= t:
                bisect.insort(self.ids, i)
                self._members.add(i)
            else:  # stale entry: the hold was extended after this push
                heapq.heappush(rel, (h, i))

    def grant(self, i: int, release: float) -> None:
        if i in self._members:
            del self.ids[bisect.bisect_left(self.ids, i)]
            self._members.discard(i)
        heapq.heappush(self._releases, (float(release), i))

    def as_array(self) -> np.ndarray:
        return np.asarray(self.ids, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.ids)


@dataclasses.dataclass
class _EpochPlan:
    """Output of the plan stage, consumed by arbitrate-and-commit."""

    admit: list[_PendingJob]
    views: list[ResidualView]
    is_backfill: list[bool]
    hol_need: tuple[int, int] | None
    # Fleet policy: one engine result per admitted job (solves already
    # counted); baselines solve lazily inside the commit stage because
    # their placement depends on the busy intervals of this epoch's
    # earlier commits.
    results: list | None


@dataclasses.dataclass
class _ServeState:
    """Mutable state threaded through one ``serve`` run's pipeline."""

    cluster: ClusterTimeline
    free_r: _FreeSet
    free_w: _FreeSet
    queue_stats: StreamingSeries
    jct_stats: StreamingSeries
    pending: list[_PendingJob] = dataclasses.field(default_factory=list)
    completions: list[float] = dataclasses.field(default_factory=list)
    records: list[JobMetrics] = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(
        default_factory=lambda: {
            "epochs": 0, "batches": 0, "solves": 0,
            "candidates": 0, "pruned": 0, "wall": 0.0,
            "backfilled": 0, "backfill_rejected": 0,
            "order_evals": 0, "epochs_reordered": 0,
            "arbitration_gain": 0.0,
            "deadline_jobs": 0, "deadline_missed": 0,
            "deadline_deferrals": 0, "deadline_rejected": 0,
            "max_overtaken": 0,
            "reconfigs": 0, "link_events": 0,
        }
    )
    peak_active: int = 0
    peak_queue: int = 0
    n_served: int = 0
    epoch_latency: list[float] | None = None
    avail_sig: tuple | None = None
    stream_exhausted: bool = False
    # Cursor into the service's sorted outage trace (events applied once).
    outage_pos: int = 0
    # Per-tier (met, total) SLO tallies, per-tenant queueing-delay
    # sketches and attained service (the wfair ordering key), and the
    # stream ids dropped by admission_control="reject".
    tier_slo: dict = dataclasses.field(default_factory=dict)
    tenant_queue: dict = dataclasses.field(default_factory=dict)
    tenant_service: dict = dataclasses.field(default_factory=dict)
    rejected_ids: list = dataclasses.field(default_factory=list)


class OnlineScheduler:
    """Serve an arrival stream on one cluster.

    Args:
      n_racks: physical racks in the cluster.
      n_wireless: physical wireless subchannels (0 = wired-only cluster,
        i.e. bandwidth augmentation off).
      window: admission window length — arrivals within ``window`` of the
        epoch-opening arrival are batched into one mega-batch solve.
        ``0.0`` gives every arrival instant its own epoch.
      policy: ``"fleet"`` (the mega-batch search engine, default) or an
        online baseline name from
        :data:`repro_torch.core.baselines.ONLINE_BASELINES` (``"fifo_solo"``
        serves one job at a time on the idle cluster; ``"greedy_list"``
        admits on residual capacity but places jobs with the G-List
        heuristic instead of searching).
      warm_start: seed each queued job's re-solve (and its admission
        solve) with its incumbent assignments. Fleet policy only.
      min_free_racks: admit only when at least this many racks are free;
        queued jobs below the threshold are planned, not placed.
      require_full_demand: admit a job only when its full demanded shape
        (``inst.n_racks`` racks and ``inst.n_wireless`` subchannels) is
        free, instead of running degraded on a smaller residual. Queued
        jobs wait (and keep re-planning) until capacity frees up; because
        the planning shape then equals the admission shape, warm-start
        incumbents transfer exactly.
      preserve_order: admit strictly in arrival order — the first queued
        job that does not fit blocks everything behind it (head-of-line
        FIFO, no overtaking). Keeps service trajectories stable under
        small makespan perturbations, at the cost of some utilization.
      backfill: relax ``preserve_order`` head-of-line blocking with
        conservative (EASY-style) backfilling: a queued job behind the
        blocked head-of-line job may be admitted out of order only when
        its *post-arbitration* completion lands at or before the head
        job's resource reservation — the earliest time the head job's
        demanded racks and subchannels can all be free given the current
        holds — so every resource the overtaker touches is released by
        then and the head-of-line admission epoch is provably never
        delayed. Requires ``preserve_order=True`` (without it every
        fitting job may overtake anyway). Ignored by the solo baselines
        (``fifo_solo`` / ``edf_solo``). Under a non-FIFO ``admission``
        order, "head-of-line" means the head of the *admission-ordered*
        queue (e.g. the earliest-deadline job under ``"edf"``) — the
        same blocking and backfill proofs apply to that order.
      seed: master seed for the per-solve engine seeds (see module
        docstring for the exact derivation).
      seed_pool_size: incumbents remembered per queued job.
      solver_kwargs: overrides merged over :data:`DEFAULT_SOLVER_KWARGS`
        and passed to :func:`repro_torch.core.vectorized.schedule_fleet`.
      compact_interval: compact the timeline's interval index every this
        many epochs (0, the default, never compacts — the full committed
        history stays inspectable on ``OnlineResult.timeline``).
        Compaction is observationally identical (same commits, same
        metrics; locked by ``tests/test_online_scale.py``) and keeps
        steady-state memory proportional to *active* jobs — turn it on
        for long streams.
      replan: ``"always"`` (default) re-solves every queued job every
        epoch — the PR 5 behavior the warm-vs-cold equal-budget
        comparisons rest on. ``"changed"`` bounds the re-plan set: a
        queued job is re-solved only when the free-capacity fingerprint
        (free rack/subchannel id sets) changed since its last planning
        solve — re-solving against an unchanged cluster can only redraw
        fresh random samples, so skipping it trades that marginal
        exploration for an O(changed) epoch cost. Changes ``n_solves``
        and (under ``warm_start``) incumbent chains; keep ``"always"``
        for budget-matched policy comparisons.
      record_jobs: keep one :class:`JobMetrics` per served job (default).
        ``False`` drops the per-job list (streaming stats, gauges and
        counters still populate) so 100k-job stress runs hold O(active)
        memory.
      track_epoch_latency: record the wall-clock seconds of each epoch's
        arbitrate-and-commit stage on ``OnlineResult.epoch_commit_latency``
        (the stress lane's flat-latency check; off by default).
      arbitration: cross-job commit-order policy within an epoch.
        ``"fifo"`` (default) commits in queue order — bit-identical to
        the pre-coflow service on every stream. ``"sigma"`` commits in
        the Sincronia-style bottleneck-first coflow order
        (:func:`repro_torch.core.coflow.sigma_order`). ``"search"`` evaluates
        candidate orders by trial-replaying them through the timeline's
        ``channel_busy`` hook (:func:`repro_torch.online.cluster
        .replay_commit_order`) and commits the best: small batches are
        solved exactly by permutation enumeration, larger ones run the
        portfolio-driven neighborhood search seeded with FIFO and sigma
        — FIFO is always evaluated, so a searched epoch never commits an
        order with a worse replayed objective than FIFO (rejected
        backfills first, then total batch JCT).
      arbitration_rounds / arbitration_pool: neighborhood-search budget
        for ``arbitration="search"`` on batches too large to enumerate —
        rounds of the portfolio allocator and candidate orders per round.
      wireless_grants: ``"hold"`` (default) grants a wireless subchannel
        only when free (its hold has expired) — exclusive grants, the
        pre-coflow behavior. ``"interval"`` additionally lets an epoch's
        admission pool reach subchannels still *held* by running jobs
        (free ones first): the busy-interval index proves exactly which
        windows are taken, so a new job's transfers gap-insert around the
        holder's — disjointness is guaranteed by the same arbitration
        pass as the wired channel (the end-of-serve audit covers it).
        Trades earlier admission for possible channel queueing on the
        shared subchannel.
      admission: queue-ordering policy for admission selection.
        ``"fifo"`` (default) considers the queue strictly in arrival
        order — bit-identical to the pre-SLO service on every stream (no
        sort, no extra RNG or float work). ``"edf"`` orders by earliest
        deadline first (deadline-less jobs last, arrival-order
        tie-break) — EDF *within feasibility*: the ordering only ranks
        the queue, every admission still passes the same capacity /
        head-of-line / backfill machinery. ``"wfair"`` orders by weighted
        attained service: each tenant accumulates the makespan of its
        committed jobs, and the queue is ranked by
        ``attained_service[tenant] / weight`` ascending (see
        ``tenant_weights``), so light / high-share tenants are served
        first and cross-tenant fairness is enforced continuously.
      admission_control: what to do about jobs whose deadline cannot be
        met. ``"none"`` (default) serves everything and just counts
        misses. ``"reject"`` drops a queued job the moment the rigorous
        proof ``now + lower_bound(inst) > deadline`` holds — the bound
        is the resource-independent critical path
        (:func:`repro_torch.core.bounds.lower_bound`), and epochs only move
        forward, so a job rejected now could never meet its deadline in
        any future epoch either; rejected ids land on
        ``OnlineResult.rejected_job_ids`` (no ``JobMetrics`` row, JCT
        aggregates unpolluted). ``"defer"`` never drops: a job whose
        *post-arbitration* completion would overrun its deadline — the
        same mutation-free trial arbitration
        :func:`repro_torch.online.cluster.replay_commit_order` replays, so the
        proof is exact, and ``replay_commit_order(...,
        deadlines=...)`` predicts every defer bit-for-bit — stays queued
        for a later (possibly less contended) epoch instead of
        committing a guaranteed miss. Deferral is bounded: once the
        deadline passes (or the lower-bound proof shows it must), the
        job serves ASAP and the miss is counted, and a job never defers
        without a future wakeup to retry on (no livelock — the deadlock
        guard stays unreachable).
      max_overtakes: starvation bound — a queued job may see at most
        this many later-arriving jobs admitted ahead of it (via non-FIFO
        admission orders or backfilling). Saturated jobs are hoisted to
        the head of the admission queue, and any admission that would
        overtake a saturated job is withheld that epoch. Overtakes are
        counted per job (``JobMetrics.n_overtaken``) and the bound is
        asserted at every commit — exceeding it raises, it is an
        invariant, not advice. ``None`` (default) counts overtakes under
        non-FIFO admission but does not bound them.
      tenant_weights: ``wfair`` share per tenant tag (falls back to the
        job's *tier* tag, then 1.0) — a tenant with weight 2 is entitled
        to twice the attained service of a weight-1 tenant before
        ranking behind it. Unknown tags default to 1.0.
      topology: wireless-link configuration policy under a
        ``cluster_topology`` — ``"static"`` (default) exposes the
        topology's reach mask as-is (minus outaged links), while
        ``"matching"`` re-matches the links to the queue's wireless
        demand every epoch (greedy weighted b-matching under the
        topology's degree limits; reconfigured subchannels are charged
        the topology's δ as busy time). Ignored without a
        ``cluster_topology``; with an all-ones topology and no outages,
        ``"static"`` serves bit-identically to no topology at all.
      cluster_topology: optional cluster-level
        :class:`~repro_torch.core.instance.Topology` over
        ``[n_racks, n_wireless]``. Residual views carry its induced mask,
        so every solver stage co-optimizes placement, channel assignment
        and the active matching. ``None`` (default) = the paper's model.
      outages: optional seeded link outage trace
        (:func:`repro_torch.online.workload.link_outage_trace`): events with
        ``time <= epoch`` flip the cluster's link state, and the active
        link set folds into the ``replan="changed"`` fingerprint so
        flaps re-solve exactly the invalidated plans.
      tracer: optional :class:`repro_torch.obs.trace.Tracer`. When set, each
        epoch records nested wall-time spans (``epoch`` →
        ``collect_arrivals`` / ``plan_batch`` / ``arbitrate_and_commit``),
        typed decision events at every admission / arbitration / backfill
        branch, per-job lifecycle marks in simulated time, and the
        metrics registry (``queue_depth`` / ``epoch_latency`` histograms,
        ``prune_rate`` / per-tier ``slo_attainment`` gauges) — export via
        :mod:`repro_torch.obs.export`, analyze via ``tools/trace_report.py``.
        The default ``None`` serves **bit-identically** through a no-op
        tracer (locked by ``tests/test_obs.py``; the stress lane asserts
        the traced overhead stays small).
      device: where the fleet engine runs — ``None`` (the CUDA card) or
        ``"cpu"``; passed on to every ``schedule_fleet`` call. Without a
        card, ``None`` raises ``RuntimeError`` here (no quiet CPU
        fallback).
    """

    def __init__(
        self,
        n_racks: int,
        n_wireless: int,
        *,
        window: float = 0.0,
        policy: str = "fleet",
        warm_start: bool = True,
        min_free_racks: int = 1,
        require_full_demand: bool = False,
        preserve_order: bool = False,
        backfill: bool = False,
        seed: int = 0,
        seed_pool_size: int = 4,
        solver_kwargs: dict | None = None,
        compact_interval: int = 0,
        replan: str = "always",
        record_jobs: bool = True,
        track_epoch_latency: bool = False,
        arbitration: str = "fifo",
        arbitration_rounds: int = 2,
        arbitration_pool: int = 8,
        wireless_grants: str = "hold",
        admission: str = "fifo",
        admission_control: str = "none",
        max_overtakes: int | None = None,
        tenant_weights: dict | None = None,
        topology: str = "static",
        cluster_topology: Topology | None = None,
        outages: Sequence[LinkEvent] | None = None,
        tracer=None,
        device=None,
    ):
        if policy != "fleet" and policy not in ONLINE_BASELINES:
            raise ValueError(
                f"unknown policy {policy!r}; "
                f"choose 'fleet' or one of {sorted(ONLINE_BASELINES)}"
            )
        if window < 0.0:
            raise ValueError("window must be non-negative")
        if not 1 <= min_free_racks <= n_racks:
            raise ValueError("min_free_racks must be in [1, n_racks]")
        if backfill and not preserve_order:
            raise ValueError(
                "backfill extends preserve_order head-of-line admission; "
                "set preserve_order=True (without it any fitting job may "
                "overtake already)"
            )
        if compact_interval < 0:
            raise ValueError("compact_interval must be non-negative")
        if replan not in ("always", "changed"):
            raise ValueError("replan must be 'always' or 'changed'")
        if arbitration not in ("fifo", "sigma", "search"):
            raise ValueError("arbitration must be 'fifo', 'sigma' or 'search'")
        if arbitration_rounds < 0:
            raise ValueError("arbitration_rounds must be non-negative")
        if arbitration_pool < 1:
            raise ValueError("arbitration_pool must be positive")
        if wireless_grants not in ("hold", "interval"):
            raise ValueError("wireless_grants must be 'hold' or 'interval'")
        if admission not in ("fifo", "edf", "wfair"):
            raise ValueError("admission must be 'fifo', 'edf' or 'wfair'")
        if admission_control not in ("none", "defer", "reject"):
            raise ValueError(
                "admission_control must be 'none', 'defer' or 'reject'"
            )
        if max_overtakes is not None and max_overtakes < 0:
            raise ValueError("max_overtakes must be non-negative (or None)")
        if tenant_weights is not None and any(
            w <= 0 for w in tenant_weights.values()
        ):
            raise ValueError("tenant_weights must be positive")
        if topology not in ("static", "matching"):
            raise ValueError("topology must be 'static' or 'matching'")
        if topology == "matching" and cluster_topology is None:
            raise ValueError("topology='matching' needs a cluster_topology")
        if outages and cluster_topology is None:
            raise ValueError("an outage trace needs a cluster_topology")
        # The deadline-aware solo baseline is fifo_solo's placement under
        # EDF queue ordering; selecting it implies the ordering unless the
        # caller explicitly asked for another one.
        if policy == "edf_solo" and admission == "fifo":
            admission = "edf"
        self.n_racks = int(n_racks)
        self.n_wireless = int(n_wireless)
        self.window = float(window)
        self.policy = policy
        self.warm_start = bool(warm_start)
        self.min_free_racks = int(min_free_racks)
        self.require_full_demand = bool(require_full_demand)
        self.preserve_order = bool(preserve_order)
        self.backfill = bool(backfill)
        self.seed = int(seed)
        self.seed_pool_size = int(seed_pool_size)
        self.solver_kwargs = dict(DEFAULT_SOLVER_KWARGS)
        if solver_kwargs:
            self.solver_kwargs.update(solver_kwargs)
        self.compact_interval = int(compact_interval)
        self.replan = replan
        self.record_jobs = bool(record_jobs)
        self.track_epoch_latency = bool(track_epoch_latency)
        self.arbitration = arbitration
        self.arbitration_rounds = int(arbitration_rounds)
        self.arbitration_pool = int(arbitration_pool)
        self.wireless_grants = wireless_grants
        self.admission = admission
        self.admission_control = admission_control
        self.max_overtakes = None if max_overtakes is None else int(max_overtakes)
        self.tenant_weights = dict(tenant_weights) if tenant_weights else {}
        self.topology = topology
        self.cluster_topology = cluster_topology
        self.outages = sorted(
            outages or [], key=lambda e: (e.time, e.rack, e.subchannel)
        )
        self.tracer = as_tracer(tracer)
        self.device = resolve_device(device)
        # Overtake bookkeeping runs only when overtakes are possible and
        # observable — the default FIFO/unbounded path skips it entirely.
        self._track_overtakes = (
            self.admission != "fifo" or self.max_overtakes is not None
        )

    # -- public API ----------------------------------------------------------

    def serve(
        self, arrivals: Sequence[ArrivalEvent] | Iterable[ArrivalEvent]
    ) -> OnlineResult:
        """Run the epoch pipeline over ``arrivals`` until every job completes.

        ``arrivals`` may be a materialized sequence (sorted here) or a lazy
        time-sorted iterator (e.g. :func:`~repro_torch.online.workload
        .stream_production_arrivals`) — the stream is consumed one epoch
        at a time.
        """
        stream = _ArrivalStream(arrivals)
        tr = self.tracer
        st = _ServeState(
            cluster=ClusterTimeline(
                self.n_racks,
                self.n_wireless,
                topology=self.cluster_topology,
                tracer=tr if tr.enabled else None,
            ),
            free_r=_FreeSet(self.n_racks),
            free_w=_FreeSet(self.n_wireless),
            queue_stats=StreamingSeries(),
            jct_stats=StreamingSeries(),
            epoch_latency=[] if self.track_epoch_latency else None,
        )

        # Wakeup comparisons are exact (no epsilon): holds are recorded at
        # exact float completion times and the free-resource queries use the
        # same ``hold <= t`` rule, so a completion popped at epoch ``t``
        # guarantees its resources are re-grantable at ``t``, while a
        # completion any amount past ``t`` stays in the heap for its own
        # epoch instead of being consumed early against still-held
        # resources (the _EPS double-booking regression).
        while not stream.exhausted or st.pending:
            t_arr = stream.peek_time() + self.window
            t_cmp = (
                st.completions[0] if (st.pending and st.completions) else np.inf
            )
            t = min(t_arr, t_cmp) if st.pending else t_arr
            if not np.isfinite(t):
                raise RuntimeError(
                    "online event loop deadlocked: jobs queued with no "
                    "outstanding completion or arrival to wake on"
                )
            k = st.counters["epochs"]
            with tr.span("epoch", epoch=k, t=float(t)) as ep_sp:
                with tr.span("collect_arrivals", epoch=k) as sp:
                    self._collect_arrivals(stream, st, t)
                    if tr.enabled:
                        sp.set(n_pending=len(st.pending))
                        tr.observe("queue_depth", len(st.pending))
                if self.admission_control != "none":
                    self._deadline_control(t, st)
                st.counters["epochs"] += 1
                with tr.span("plan_batch", epoch=k) as sp:
                    plan = self._plan_batch(t, st)
                    if tr.enabled:
                        sp.set(n_admit=len(plan.admit) if plan else 0)
                with tr.span("arbitrate_and_commit", epoch=k) as sp:
                    t0 = (
                        _time.perf_counter()
                        if st.epoch_latency is not None and not tr.enabled
                        else 0.0
                    )
                    new_completions = self._arbitrate_and_commit(t, st, plan)
                    if st.epoch_latency is not None and not tr.enabled:
                        st.epoch_latency.append(_time.perf_counter() - t0)
                    if tr.enabled:
                        sp.set(n_committed=len(new_completions))
                # When traced, the commit latency IS the span duration, so
                # the exported trace reconciles with epoch_commit_latency
                # exactly instead of within span-entry overhead.
                if tr.enabled and st.epoch_latency is not None:
                    st.epoch_latency.append(sp.duration)
                for comp in new_completions:
                    heapq.heappush(st.completions, comp)
                st.peak_active = max(st.peak_active, len(st.completions))
                if (
                    self.compact_interval
                    and st.counters["epochs"] % self.compact_interval == 0
                ):
                    st.cluster.compact(t)
            if tr.enabled:
                tr.observe("epoch_latency", ep_sp.duration)

        st.cluster.assert_feasible()
        st.records.sort(key=lambda r: r.job_id)
        horizon = st.cluster.last_completion
        util = st.cluster.utilization(horizon)
        if tr.enabled:
            # End-of-serve registry snapshot for the Prometheus
            # exposition: prune/SLO gauges, the streaming sketches by
            # reference, and every serve counter.
            tr.gauge(
                "prune_rate",
                st.counters["pruned"] / max(st.counters["candidates"], 1),
            )
            for tier, (met, tot) in sorted(st.tier_slo.items()):
                if tot:
                    tr.gauge("slo_attainment", met / tot, tier=tier)
            tr.adopt_series("queueing_delay", st.queue_stats)
            tr.adopt_series("jct", st.jct_stats)
            for tenant, series in sorted(st.tenant_queue.items()):
                tr.adopt_series("tenant_queueing_delay", series, tenant=tenant)
            for name, v in st.counters.items():
                tr.count(f"serve_{name}", float(v))
        return OnlineResult(
            jobs=st.records,
            policy=self.policy,
            warm_start=self.warm_start and self.policy == "fleet",
            n_epochs=st.counters["epochs"],
            n_batches=st.counters["batches"],
            n_solves=st.counters["solves"],
            n_candidates=st.counters["candidates"],
            n_pruned=st.counters["pruned"],
            solver_wall=st.counters["wall"],
            horizon=horizon,
            rack_utilization=util["rack"],
            wired_utilization=util["wired"],
            wireless_utilization=util["wireless"],
            n_backfilled=st.counters["backfilled"],
            n_backfill_rejected=st.counters["backfill_rejected"],
            timeline=st.cluster,
            queue_stats=st.queue_stats,
            jct_stats=st.jct_stats,
            peak_active=st.peak_active,
            peak_queue_depth=st.peak_queue,
            n_served=st.n_served,
            epoch_commit_latency=st.epoch_latency,
            arbitration=self.arbitration,
            n_order_evals=st.counters["order_evals"],
            n_epochs_reordered=st.counters["epochs_reordered"],
            arbitration_gain=st.counters["arbitration_gain"],
            admission=self.admission,
            n_deadline_jobs=st.counters["deadline_jobs"],
            n_deadline_missed=st.counters["deadline_missed"],
            n_deadline_deferrals=st.counters["deadline_deferrals"],
            n_deadline_rejected=st.counters["deadline_rejected"],
            rejected_job_ids=st.rejected_ids,
            tier_slo=st.tier_slo,
            tenant_queue_stats=st.tenant_queue,
            max_overtakes_observed=st.counters["max_overtaken"],
            n_reconfigs=st.counters["reconfigs"],
            n_link_events=st.counters["link_events"],
        )

    # -- stage 1: collect ----------------------------------------------------

    def _collect_arrivals(
        self, stream: _ArrivalStream, st: _ServeState, t: float
    ) -> None:
        """Pull arrivals due at epoch ``t`` into the queue, retire due
        completions, and advance the free sets to ``t``."""
        tr = self.tracer
        while not stream.exhausted and stream.peek_time() <= t:
            ev = stream.pop()
            st.pending.append(_PendingJob(ev))
            if tr.enabled:
                tr.job(
                    ev.job_id,
                    "arrival",
                    ev.time,
                    family=ev.family,
                    tenant=ev.tenant,
                    tier=ev.tier,
                    deadline=ev.deadline,
                )
        st.peak_queue = max(st.peak_queue, len(st.pending))
        while st.completions and st.completions[0] <= t:
            heapq.heappop(st.completions)
        st.free_r.advance(t, st.cluster.rack_hold)
        st.free_w.advance(t, st.cluster.wireless_hold)
        st.stream_exhausted = stream.exhausted
        if st.cluster.topology is not None:
            self._epoch_topology(t, st)
        if self.replan == "changed":
            sig = (tuple(st.free_r.ids), tuple(st.free_w.ids))
            tsig = st.cluster.topology_signature()
            if tsig is not None:
                # Matching / outage changes invalidate cached plans: a
                # schedule solved under the old link set may pick a now
                # unreachable subchannel.
                sig = sig + (tsig,)
            st.avail_sig = sig

    def _epoch_topology(self, t: float, st: _ServeState) -> None:
        """Advance the reconfigurable-topology state to epoch ``t``: apply
        due outage-trace events, then (under ``topology="matching"``)
        re-match the wireless links to the queue's demand.

        The matching weight is the queue's aggregate wireless transfer
        volume placed on the racks currently free at ``t`` — pending jobs
        are not placed yet, so per-rack demand is unknowable; weighting
        the free racks steers links toward where the epoch's admissions
        can actually land, and the greedy matcher's deterministic
        tie-break does the rest. Subchannels mid-transfer keep their
        links; every reconfigured idle subchannel is charged δ as a busy
        interval by the timeline. Both steps are traced as decision
        events (``link_outage`` / ``topology_matching``).
        """
        cluster = st.cluster
        tr = self.tracer
        flipped = 0
        while st.outage_pos < len(self.outages):
            ev = self.outages[st.outage_pos]
            if ev.time > t:
                break
            flipped += cluster.set_link(ev.rack, ev.subchannel, ev.up)
            st.outage_pos += 1
        if flipped:
            st.counters["link_events"] += flipped
            if tr.enabled:
                tr.event(
                    "link_outage",
                    t=float(t),
                    n_links_changed=flipped,
                    n_up=int(cluster.link_state.sum()),
                )
        if self.topology != "matching":
            return
        demand = np.zeros(self.n_racks, dtype=np.float64)
        vol = 0.0
        for p in st.pending:
            inst = p.event.inst
            if inst.n_wireless and inst.job.n_edges:
                vol += float(np.sum(inst.q_wireless))
        if vol > 0.0:
            demand[st.free_r.as_array()] = vol
        n_re = cluster.reconfigure(demand, t)
        if n_re:
            st.counters["reconfigs"] += n_re
        if tr.enabled:
            tr.event(
                "topology_matching",
                t=float(t),
                n_reconfigured=n_re,
                n_active=int(cluster.active_reach().sum()),
                demand_volume=float(vol),
            )

    def _deadline_control(self, t: float, st: _ServeState) -> None:
        """Resolve provably unmeetable deadlines at epoch ``t``.

        The proof is the rigorous resource-independent critical-path
        bound: no scheduler on any cluster can finish ``inst`` in under
        ``lower_bound(inst)`` time, so ``t + lower_bound(inst) >
        deadline`` is a certificate the deadline is lost — and since the
        event loop only moves forward, lost forever. Under
        ``admission_control="reject"`` the job is dropped from the queue
        (counted, id recorded); under ``"defer"`` it is marked hopeless
        so the commit stage stops deferring it (it serves ASAP and the
        miss is counted). The bound is computed once per job and cached.
        """
        doomed: list[_PendingJob] = []
        for p in st.pending:
            ddl = p.event.deadline
            if ddl is None or p.hopeless:
                continue
            if p.lb is None:
                p.lb = lower_bound(p.event.inst)
            if t + p.lb > ddl:
                if self.admission_control == "reject":
                    doomed.append(p)
                else:
                    p.hopeless = True
                    if self.tracer.enabled:
                        self.tracer.event(
                            "deadline_hopeless",
                            job_id=p.event.job_id,
                            t=float(t),
                            deadline=float(ddl),
                            lower_bound=float(p.lb),
                        )
        for p in doomed:
            st.pending.remove(p)
            st.counters["deadline_rejected"] += 1
            st.rejected_ids.append(p.event.job_id)
            if self.tracer.enabled:
                # The rejection proof: t + lower_bound(inst) > deadline.
                self.tracer.event(
                    "deadline_reject",
                    job_id=p.event.job_id,
                    t=float(t),
                    deadline=float(p.event.deadline),
                    lower_bound=float(p.lb),
                )

    # -- stage 2: plan -------------------------------------------------------

    def _engine_seed(self, job: _PendingJob, planning: bool) -> int:
        base = self.seed + 1009 * job.event.job_id
        return base + 9173 * job.n_solves if planning else base

    def _hol_need(self, inst) -> tuple[int, int]:
        """Racks and wireless subchannels a blocked head-of-line job needs
        free before it can be admitted (demands clamped to the cluster)."""
        need_r = self.min_free_racks
        need_w = 0
        if self.require_full_demand:
            need_r = max(need_r, min(inst.n_racks, self.n_racks))
            need_w = min(inst.n_wireless, self.n_wireless)
        return need_r, need_w

    def _admission_queue(self, st: _ServeState) -> list[_PendingJob]:
        """The queue in admission order.

        ``admission="fifo"`` returns the pending list itself — no copy,
        no sort, no float work, so the default path is bit-identical to
        the pre-SLO loop. ``"edf"`` stable-sorts by
        ``(deadline, arrival)`` with deadline-less jobs last; ``"wfair"``
        by weighted attained tenant service (ties by arrival). When a
        ``max_overtakes`` bound is set, saturated jobs (overtaken the
        full allowance) are hoisted to the head in arrival order — they
        must be next, and the selection loop below refuses any admission
        that would overtake them again.
        """
        if self.admission == "fifo":
            return st.pending
        if self.admission == "edf":
            def key(p: _PendingJob):
                d = p.event.deadline
                return (d if d is not None else np.inf, p.event.job_id)
        else:  # wfair
            def key(p: _PendingJob):
                ev = p.event
                w = self.tenant_weights.get(
                    ev.tenant, self.tenant_weights.get(ev.tier, 1.0)
                )
                return (
                    st.tenant_service.get(ev.tenant, 0.0) / w,
                    ev.job_id,
                )
        bound = self.max_overtakes
        if bound is not None:
            head = [p for p in st.pending if p.n_overtaken >= bound]
            if head:  # pending is arrival-ordered, so head is too
                tail = [p for p in st.pending if p.n_overtaken < bound]
                return head + sorted(tail, key=key)
        return sorted(st.pending, key=key)

    def _select_admissions(self, t: float, st: _ServeState) -> _EpochPlan:
        """Admission selection: draw disjoint residual views from shrinking
        pools; order-preserving modes flag overtake candidates."""
        cluster = st.cluster
        hol_need = None  # head-of-line protection bound for backfills
        queue = self._admission_queue(st)
        if self.tracer.enabled and queue is not st.pending:
            ordered = [p.event.job_id for p in queue]
            if ordered != [p.event.job_id for p in st.pending]:
                self.tracer.event(
                    "admission_reorder",
                    policy=self.admission,
                    order=ordered,
                )
        if self.policy in ("fifo_solo", "edf_solo"):
            # Solo rule: head-of-queue job only, and only on a fully idle
            # cluster (every rack free implies every channel free too —
            # channel holds never outlast the rack hold of the consumer).
            if len(st.free_r) < self.n_racks:
                return _EpochPlan([], [], [], None, None)
            admit = queue[:1]
            views = [cluster.residual_view(admit[0].event.inst, t)]
            return _EpochPlan(admit, views, [False], None, None)
        # Racks AND wireless subchannels granted within one epoch are
        # mutually exclusive: each admitted job consumes its grant
        # from a shrinking pool, so later jobs of the epoch see only
        # what is left. The shared wired channel is never granted —
        # cross-job wired contention is resolved at commit time by the
        # timeline's arbitration pass.
        pool = st.free_r.as_array()
        pool_w = st.free_w.as_array()
        if self.wireless_grants == "interval" and self.n_wireless:
            # Interval-aware grants: subchannels still held by running
            # jobs join the back of the epoch pool (free ones are granted
            # first). A job granted a held subchannel gap-inserts its
            # transfers around the holder's committed windows — the same
            # arbitration pass that already shares the wired channel —
            # so exclusivity of the *grant* is relaxed while per-interval
            # disjointness stays audited. Racks stay exclusive: the
            # simulator re-derives only channel times, never rack times.
            held = np.setdiff1d(
                np.arange(self.n_wireless, dtype=np.int64), pool_w
            )
            if held.size:
                pool_w = np.concatenate([pool_w, held])
        admit, views, is_backfill = [], [], []
        blocked = False  # head-of-line blocked (order-preserving modes)
        # Starvation-bound bookkeeping (only under _track_overtakes):
        # ``prospective`` counts, per still-queued job, the overtakes
        # *this epoch's* selections would add if every admission commits;
        # ``firm`` holds ids of admissions that are certain to commit
        # (not backfill candidates, not defer-eligible), whose co-epoch
        # admission is simultaneous — not an overtake. The check below is
        # conservative: a commit-stage rejection can only return counted
        # prospective overtakes, never add uncounted ones, so the
        # commit-time assertion holds by construction.
        bound = self.max_overtakes
        prospective: dict[int, int] = {}
        firm: set[int] = set()
        for p in queue:
            inst = p.event.inst
            ok = pool.size >= self.min_free_racks
            if ok and self.require_full_demand:
                # Demands are clamped to the cluster shape so an
                # oversized job can still (eventually) be admitted.
                ok = (
                    pool.size >= min(inst.n_racks, self.n_racks)
                    and pool_w.size >= min(inst.n_wireless, self.n_wireless)
                )
            overtakes = self.preserve_order and blocked
            if overtakes and not self.backfill:
                ok = False  # head-of-line blocking: no overtaking
            if ok and bound is not None:
                # Withhold any admission that would push an earlier-
                # arrived, still-queued job past its overtake allowance.
                jid = p.event.job_id
                for q in st.pending:
                    if (
                        q is not p
                        and q.event.job_id < jid
                        and id(q) not in firm
                        and q.n_overtaken + prospective.get(id(q), 0)
                        >= bound
                    ):
                        ok = False
                        break
            if ok:
                view = cluster.residual_view(
                    inst, t, rack_pool=pool, wireless_pool=pool_w
                )
                pool = pool[view.inst.n_racks :]
                pool_w = pool_w[view.inst.n_wireless :]
                admit.append(p)
                views.append(view)
                # An overtaker is only a *candidate*: its commit below
                # must pass the head-of-line no-delay proof
                # (``_backfill_safe``) or it stays queued (the racks
                # it consumed from the pool stay unused this epoch —
                # conservative and deterministic).
                is_backfill.append(overtakes)
                if bound is not None:
                    jid = p.event.job_id
                    for q in st.pending:
                        if (
                            q is not p
                            and q.event.job_id < jid
                            and id(q) not in firm
                        ):
                            prospective[id(q)] = (
                                prospective.get(id(q), 0) + 1
                            )
                    if not overtakes and not (
                        self.admission_control == "defer"
                        and p.event.deadline is not None
                        and not p.hopeless
                    ):
                        firm.add(id(p))
            elif self.preserve_order and not blocked:
                blocked = True
                hol_need = self._hol_need(inst)
        return _EpochPlan(admit, views, is_backfill, hol_need, None)

    def _plan_batch(self, t: float, st: _ServeState) -> _EpochPlan | None:
        """Admission selection plus the epoch's single mega-batch launch."""
        if not st.pending:
            return None
        plan = self._select_admissions(t, st)
        if self.policy != "fleet":
            return plan
        # Queued ("plan") jobs are re-solved every epoch in BOTH warm
        # and cold modes: cold-start re-optimization means searching
        # from scratch each epoch, and running its (discarded)
        # planning solves keeps warm-vs-cold an equal-total-budget
        # comparison — the benchmarks' warm_solves == cold_solves
        # records rest on this. Cold planning never changes a
        # committed schedule (admission solves ignore history), only
        # solver_wall/n_solves. (``replan="changed"`` opts out: it
        # skips queued jobs whose free-capacity fingerprint is
        # unchanged since their last solve.)
        admitted = set(map(id, plan.admit))
        queued = [p for p in st.pending if id(p) not in admitted]
        if self.replan == "changed":
            queued = [
                p
                for p in queued
                if p.n_solves == 0 or p.view_sig != st.avail_sig
            ]
            for p in queued:
                p.view_sig = st.avail_sig
        batch = plan.admit + queued
        if not batch:
            return plan
        instances = [v.inst for v in plan.views] + [
            p.event.inst for p in queued
        ]
        seeds = [self._engine_seed(p, planning=False) for p in plan.admit] + [
            self._engine_seed(p, planning=True) for p in queued
        ]
        seed_pools = None
        if self.warm_start:
            seed_pools = [
                np.stack(p.incumbents, axis=0) if p.incumbents else None
                for p in batch
            ]
        t0 = _time.perf_counter()
        fleet = schedule_fleet(
            instances,
            seed=seeds,
            seed_pools=seed_pools,
            op_tables=[p.tables() for p in batch],
            tracer=self.tracer if self.tracer.enabled else None,
            device=self.device,
            **self.solver_kwargs,
        )
        st.counters["wall"] += _time.perf_counter() - t0
        st.counters["batches"] += 1
        st.counters["solves"] += len(batch)
        st.counters["candidates"] += fleet.n_candidates
        st.counters["pruned"] += fleet.n_pruned
        for p, inst, res in zip(batch, instances, fleet.results):
            p.n_solves += 1
            p.remember(res, _shape_key(inst), self.seed_pool_size)
        plan.results = fleet.results[: len(plan.admit)]
        return plan

    # -- stage 3: arbitrate & commit -----------------------------------------

    def _backfill_safe(
        self,
        cluster: ClusterTimeline,
        view: ResidualView,
        completion: float,
        t: float,
        hol_need: tuple[int, int],
    ) -> bool:
        """Prove (or refuse) that committing a backfill candidate cannot
        delay the blocked head-of-line job's admission epoch.

        The head job's *reservation* is the earliest time its needed racks
        and subchannels can all be free given the holds committed so far —
        including this epoch's earlier commits, which is why the proof
        runs at commit time, on current holds, per candidate. The commit
        is safe when either

        * the candidate's post-arbitration ``completion`` lands at or
          before the reservation (every hold a job takes — racks and
          channels alike — is released by its completion, so everything
          the candidate touches is free again in time), or
        * shadow slack: even with the candidate's grant removed for good,
          the reservation time still has enough free racks/subchannels
          for the head job (its demand is met without the candidate's
          resources, so the candidate may run arbitrarily long).

        Either branch preserves the invariant that at the current
        reservation the head job's demand is satisfiable, so the head job
        is admitted at the first wakeup past it — exactly as it would be
        with no overtaking (backfill completions only *add* wakeups).

        The proof itself is the pure hold-vector function
        :func:`repro_torch.online.cluster.reservation_backfill_safe`, shared
        with the order search's trial replay so a replayed epoch makes
        bit-identical backfill decisions."""
        return reservation_backfill_safe(
            cluster.rack_hold,
            cluster.wireless_hold,
            view.inst.n_racks,
            view.inst.n_wireless,
            completion,
            t,
            hol_need,
        )

    def _commit_job(
        self,
        t: float,
        st: _ServeState,
        p: _PendingJob,
        view: ResidualView,
        placed: Schedule,
        solver_mk: float,
        backfilled: bool,
        solver_sched: Schedule | None = None,
    ) -> float:
        """Land one arbitrated schedule: timeline commit, free-set grants,
        streaming stats, and (optionally) the per-job record.

        ``solver_sched`` (fleet policy) is the pre-arbitration schedule;
        traced serves diff it against ``placed`` to attribute the job's
        cross-job channel queueing to wired vs wireless resources."""
        holds: list[tuple[str, int, float]] = []
        comp = st.cluster.commit(
            view, placed, t, job_id=p.event.job_id, holds_out=holds
        )
        for kind, phys, hold in holds:
            (st.free_r if kind == "rack" else st.free_w).grant(phys, hold)
        st.counters["backfilled"] += backfilled
        st.n_served += 1
        st.queue_stats.push(t - p.event.time)
        st.jct_stats.push(comp - p.event.time)
        ev = p.event
        if ev.deadline is not None:
            st.counters["deadline_jobs"] += 1
            met = comp <= ev.deadline
            if not met:
                st.counters["deadline_missed"] += 1
            if ev.tier is not None:
                m, tot = st.tier_slo.get(ev.tier, (0, 0))
                st.tier_slo[ev.tier] = (m + int(met), tot + 1)
        if ev.tenant is not None:
            series = st.tenant_queue.get(ev.tenant)
            if series is None:
                series = st.tenant_queue[ev.tenant] = StreamingSeries()
            series.push(t - ev.time)
            st.tenant_service[ev.tenant] = (
                st.tenant_service.get(ev.tenant, 0.0) + float(placed.makespan)
            )
        if self.record_jobs:
            st.records.append(
                self._record(p, view, t, comp, placed, solver_mk, backfilled)
            )
        tr = self.tracer
        if tr.enabled:
            qw, qwl = (
                channel_delay_attribution(view, solver_sched, placed)
                if solver_sched is not None
                else (0.0, 0.0)
            )
            tr.job(ev.job_id, "admit", float(t), backfilled=bool(backfilled))
            tr.job(
                ev.job_id,
                "complete",
                float(comp),
                makespan=float(placed.makespan),
                solver_makespan=float(solver_mk),
                queue_wired=qw,
                queue_wireless=qwl,
                n_racks=view.inst.n_racks,
                n_wireless=view.inst.n_wireless,
                backfilled=bool(backfilled),
            )
        return comp

    def _should_defer(
        self,
        p: _PendingJob,
        t: float,
        comp: float,
        st: _ServeState,
        new_completions: list[float],
    ) -> bool:
        """Deadline-defer decision for one arbitrated commit candidate.

        ``comp`` is the candidate's post-arbitration completion — the
        output of the exact same trial arbitration
        :func:`repro_torch.online.cluster.replay_commit_order` runs per
        position, so ``replay_commit_order(..., deadlines=...)`` over the
        epoch's committed prefix predicts every defer decision
        bit-for-bit (``tests/test_admission.py`` locks the parity).
        Deferring requires a future wakeup (an outstanding completion,
        one committed earlier this epoch, or more arrivals) so the event
        loop can never deadlock on an all-deferred queue, and stops once
        the deadline has passed or is provably lost (``hopeless``): the
        job then serves ASAP and the miss is counted.
        """
        if self.admission_control != "defer" or p.hopeless:
            return False
        ddl = p.event.deadline
        if ddl is None or comp <= ddl or t > ddl:
            return False
        return (
            bool(st.completions)
            or bool(new_completions)
            or not st.stream_exhausted
        )

    def _count_overtakes(
        self, st: _ServeState, committed: list[_PendingJob]
    ) -> None:
        """Charge this epoch's commits against the jobs still queued.

        Every committed job with a larger stream id than a still-pending
        job overtook it (job ids are arrival order — ties broken the
        same way the stream is sorted). The ``max_overtakes`` bound is
        asserted here, at the moment of counting: the selection-stage
        barrier makes a violation unreachable, so tripping this raise
        means the starvation bound was actually broken, not merely
        approached.
        """
        for q in st.pending:
            inc = sum(
                1 for c in committed if c.event.job_id > q.event.job_id
            )
            if not inc:
                continue
            q.n_overtaken += inc
            if q.n_overtaken > st.counters["max_overtaken"]:
                st.counters["max_overtaken"] = q.n_overtaken
            if (
                self.max_overtakes is not None
                and q.n_overtaken > self.max_overtakes
            ):
                raise RuntimeError(
                    f"starvation bound violated: job {q.event.job_id} "
                    f"overtaken {q.n_overtaken} times "
                    f"(max_overtakes={self.max_overtakes})"
                )

    def _arbitrate_and_commit(
        self, t: float, st: _ServeState, plan: _EpochPlan | None
    ) -> list[float]:
        """Arbitrate each admitted schedule onto the shared channels and
        commit the survivors; returns their completion times."""
        if plan is None or not plan.admit:
            return []
        cluster = st.cluster
        new_completions: list[float] = []
        committed: list[_PendingJob] = []
        if self.policy == "fleet":
            serve_scheds: list[Schedule] = []
            serve_mks: list[float] = []
            for p, view, res in zip(plan.admit, plan.views, plan.results):
                sched, mk = res.schedule, res.makespan
                if (
                    self.warm_start
                    and p.best_makespan < mk
                    and p.best_shape == _shape_key(view.inst)
                ):
                    # Keep-incumbent re-optimization: the fresh solve did
                    # not beat the chain's best simulated schedule for
                    # this exact resource shape, so serve the incumbent.
                    sched, mk = p.best_sched, p.best_makespan
                serve_scheds.append(sched)
                serve_mks.append(mk)
            order = self._commit_order(t, st, plan, serve_scheds)
            for i in order:
                p, view, bf = plan.admit[i], plan.views[i], plan.is_backfill[i]
                # Cross-job arbitration: sequence the served schedule onto
                # the shared physical channels in the chosen commit order
                # (queue order under the default ``arbitration="fifo"``;
                # identity when the channels are clear).
                placed = cluster.arbitrate(view, serve_scheds[i], t)
                if bf and not self._backfill_safe(
                    cluster, view, t + placed.makespan, t, plan.hol_need
                ):
                    # Arbitration cannot prove the overtake harmless: the
                    # candidate would hold a resource the head-of-line job
                    # needs past its reservation. It stays queued; its
                    # solve already fed the warm-start incumbents above.
                    st.counters["backfill_rejected"] += 1
                    if self.tracer.enabled:
                        self.tracer.event(
                            "backfill_reject",
                            job_id=p.event.job_id,
                            completion=float(t + placed.makespan),
                        )
                    continue
                if self._should_defer(
                    p, t, t + float(placed.makespan), st, new_completions
                ):
                    # The trial completion overruns the deadline: a
                    # commit now is a proven miss, so the job stays
                    # queued for a less contended epoch.
                    st.counters["deadline_deferrals"] += 1
                    if self.tracer.enabled:
                        self.tracer.event(
                            "deadline_defer",
                            job_id=p.event.job_id,
                            completion=float(t + placed.makespan),
                            deadline=float(p.event.deadline),
                        )
                    continue
                if bf and self.tracer.enabled:
                    self.tracer.event(
                        "backfill_commit",
                        job_id=p.event.job_id,
                        completion=float(t + placed.makespan),
                    )
                comp = self._commit_job(
                    t, st, p, view, placed, serve_mks[i], bf,
                    solver_sched=serve_scheds[i],
                )
                new_completions.append(comp)
                committed.append(p)
        else:
            # Online baselines commit through the same feasible path: the
            # per-job heuristic is handed the busy intervals already
            # committed on its physical channels and gap-inserts its own
            # transfers around them (``channel_busy`` seeds the same
            # timeline machinery the replay uses), so its schedule is
            # already cross-job arbitrated — committing it directly keeps
            # the heuristic's placement and skips a redundant replay.
            # Solving stays in this stage, not ``_plan_batch``, because
            # each placement depends on the busy intervals of this
            # epoch's *earlier* commits. The end-of-serve audit verifies
            # the invariant like everywhere else.
            fn = ONLINE_BASELINES[self.policy]
            order = self._commit_order(t, st, plan, None)
            for i in order:
                p, view, bf = plan.admit[i], plan.views[i], plan.is_backfill[i]
                t0 = _time.perf_counter()
                placed = fn(
                    view.inst,
                    use_wireless=view.inst.n_wireless > 0,
                    channel_busy=cluster.channel_busy(view, t),
                )
                st.counters["wall"] += _time.perf_counter() - t0
                st.counters["solves"] += 1
                p.n_solves += 1
                if bf and not self._backfill_safe(
                    cluster, view, t + placed.makespan, t, plan.hol_need
                ):
                    st.counters["backfill_rejected"] += 1
                    if self.tracer.enabled:
                        self.tracer.event(
                            "backfill_reject",
                            job_id=p.event.job_id,
                            completion=float(t + placed.makespan),
                        )
                    continue
                if self._should_defer(
                    p, t, t + float(placed.makespan), st, new_completions
                ):
                    st.counters["deadline_deferrals"] += 1
                    if self.tracer.enabled:
                        self.tracer.event(
                            "deadline_defer",
                            job_id=p.event.job_id,
                            completion=float(t + placed.makespan),
                            deadline=float(p.event.deadline),
                        )
                    continue
                if bf and self.tracer.enabled:
                    self.tracer.event(
                        "backfill_commit",
                        job_id=p.event.job_id,
                        completion=float(t + placed.makespan),
                    )
                comp = self._commit_job(
                    t, st, p, view, placed, placed.makespan, bf
                )
                new_completions.append(comp)
                committed.append(p)

        for p in committed:
            st.pending.remove(p)
        if self._track_overtakes and committed and st.pending:
            self._count_overtakes(st, committed)
        return new_completions

    def _commit_order(
        self,
        t: float,
        st: _ServeState,
        plan: _EpochPlan,
        scheds: list[Schedule] | None,
    ) -> Sequence[int]:
        """Choose the epoch's cross-job commit order (batch positions,
        first-to-commit first).

        ``arbitration="fifo"`` — and any single-job batch — returns the
        identity immediately: no replay, no RNG, no float work, so the
        default service is bit-identical to the pre-coflow commit loop.
        ``"sigma"`` commits the bottleneck-first coflow order
        unconditionally (replaying FIFO and sigma once each only to feed
        the ``arbitration_gain`` counter). ``"search"`` minimizes the
        replayed objective — ``(backfills rejected, total batch JCT)``,
        lexicographic — over permutations: exhaustively for small
        batches, portfolio neighborhood search seeded with sigma
        otherwise; FIFO is always evaluated first, so the committed
        order's replayed objective is never worse than FIFO's.

        ``scheds`` carries the fleet policy's already-served schedules
        (exact per-resource coflow demands); baselines pass ``None`` and
        are replayed through their lazy per-commit solver with a
        wired-volume proxy coflow for the sigma seed.
        """
        n = len(plan.admit)
        if self.arbitration == "fifo" or n <= 1:
            return range(n)
        solver = None
        if scheds is None:
            fn = ONLINE_BASELINES[self.policy]

            def solver(view, busy):
                return fn(
                    view.inst,
                    use_wireless=view.inst.n_wireless > 0,
                    channel_busy=busy,
                )

        arrivals = [p.event.time for p in plan.admit]

        def evaluate(order):
            return replay_commit_order(
                st.cluster,
                t,
                plan.views,
                order,
                scheds=scheds,
                solver=solver,
                arrivals=arrivals,
                is_backfill=plan.is_backfill,
                hol_need=plan.hol_need,
            ).objective

        if scheds is not None:
            coflows = [
                coflow_from_schedule(v, s, index=i, job_id=p.event.job_id)
                for i, (p, v, s) in enumerate(
                    zip(plan.admit, plan.views, scheds)
                )
            ]
        else:
            coflows = [
                coflow_from_instance(p.event.inst, index=i, job_id=p.event.job_id)
                for i, p in enumerate(plan.admit)
            ]
        fifo = tuple(range(n))
        sigma = tuple(sigma_order(coflows))
        if self.arbitration == "sigma":
            fifo_obj = evaluate(fifo)
            chosen, chosen_obj = sigma, fifo_obj
            st.counters["order_evals"] += 1
            if sigma != fifo:
                chosen_obj = evaluate(sigma)
                st.counters["order_evals"] += 1
        else:
            rng = np.random.default_rng(
                self.seed + 6151 * st.counters["epochs"]
            )
            res = search_commit_order(
                evaluate,
                n,
                rng=rng,
                seeds=(sigma,),
                rounds=self.arbitration_rounds,
                pool_size=self.arbitration_pool,
            )
            chosen, chosen_obj, fifo_obj = (
                res.order, res.objective, res.fifo_objective
            )
            st.counters["order_evals"] += res.n_evals
        if chosen != fifo:
            st.counters["epochs_reordered"] += 1
        # Replayed total-JCT delta vs FIFO for this epoch (positive =
        # improvement; sigma commits its order even when negative).
        st.counters["arbitration_gain"] += fifo_obj[1] - chosen_obj[1]
        if self.tracer.enabled:
            self.tracer.event(
                "arbitration_order",
                policy=self.arbitration,
                order=[plan.admit[i].event.job_id for i in chosen],
                gain=float(fifo_obj[1] - chosen_obj[1]),
                reordered=chosen != fifo,
            )
        return chosen

    @staticmethod
    def _record(
        p: _PendingJob,
        view: ResidualView,
        t: float,
        comp: float,
        placed: Schedule,
        solver_mk: float,
        backfilled: bool,
    ) -> JobMetrics:
        return JobMetrics(
            job_id=p.event.job_id,
            family=p.event.family,
            arrival=p.event.time,
            admitted=t,
            completion=comp,
            makespan=placed.makespan,
            n_racks_granted=view.inst.n_racks,
            n_wireless_granted=view.inst.n_wireless,
            n_solves=p.n_solves,
            solver_makespan=float(solver_mk),
            backfilled=bool(backfilled),
            assignment=view.rack_map[np.asarray(placed.rack, dtype=np.int64)],
            deadline=p.event.deadline,
            tenant=p.event.tenant,
            tier=p.event.tier,
            n_overtaken=p.n_overtaken,
        )
