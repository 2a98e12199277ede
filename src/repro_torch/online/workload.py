# Copied from src/repro/online/workload.py; imports retargeted to repro_torch.
"""Arrival-stream workload generators for the online scheduling service.

Every solver below :mod:`repro_torch.online` is single-shot offline; this module
supplies the missing half of the paper's "production scenario" (§V): jobs
*arriving over time* and competing for the same wired channel, wireless
subchannels, and racks. Three generators, all emitting reproducible
streams of :class:`ArrivalEvent`:

  * :func:`poisson_arrivals` — memoryless arrivals at a given rate over
    the §V job families (``JOB_FAMILIES``), every job demanding the full
    cluster shape.
  * :func:`production_arrivals` — the paper's §V production-scenario mix:
    family weights skewed toward MapReduce workflows, task counts
    U[5, 10], fan-out drawn per family, per-job network factor rho drawn
    from a weighted palette (the heavy tail models shuffle-dominant
    jobs), and per-job rack demand below the full cluster so admission
    actually has packing decisions to make.
  * :func:`trace_arrivals` — trace-driven replay of explicit
    ``(arrival_time, job)`` pairs.

The seeded generators are *streaming first*: :func:`stream_poisson_arrivals`
and :func:`stream_production_arrivals` yield events lazily in arrival
order (O(1) memory per event), which is what lets the stress lane push
100k-arrival traces through the service without materializing them. The
list-returning functions above are thin ``list(...)`` wrappers over the
streams and emit bit-identical events.

SLO tiers and tenants
---------------------
:func:`stream_tiered_arrivals` decorates *any* arrival stream with
multi-tenant SLO metadata: each job draws a tenant tag and an SLO tier
(:class:`SloTier`) from a seeded mix, and tiers with finite slack get a
deadline ``arrival + slack * lower_bound(inst)`` — the rigorous
resource-independent critical-path bound from :mod:`repro_torch.core.bounds`,
so a slack of 1.0 is the tightest deadline any scheduler could ever
meet. The tier draw uses its *own* RNG (derived from, but independent
of, the base seed), so the underlying arrival times / DAGs / demands are
bit-identical to the untiered stream — tiering is a pure annotation
layer. :func:`tiered_poisson_arrivals` and
:func:`tiered_production_arrivals` are the pre-composed list forms.

Determinism contract: a generator called twice with the same seed and
parameters returns bit-identical streams (same arrival times, same DAGs,
same demands). Streams are sorted by arrival time, times are
non-negative, and every generated instance is feasible by construction —
``tests/test_online.py`` locks all three properties in.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

import numpy as np

from repro_torch.core.dag import (
    DagJob,
    JOB_FAMILIES,
    make_onestage_mapreduce,
    make_random_workflow,
    make_simple_mapreduce,
)
from repro_torch.core.bounds import lower_bound
from repro_torch.core.instance import ProblemInstance

__all__ = [
    "ArrivalEvent",
    "LinkEvent",
    "SloTier",
    "DEFAULT_SLO_TIERS",
    "link_outage_trace",
    "poisson_arrivals",
    "production_arrivals",
    "stream_poisson_arrivals",
    "stream_production_arrivals",
    "stream_tiered_arrivals",
    "tiered_poisson_arrivals",
    "tiered_production_arrivals",
    "trace_arrivals",
    "PRODUCTION_FAMILY_WEIGHTS",
    "PRODUCTION_RHO_PALETTE",
]


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One job arrival.

    Attributes:
      time: absolute arrival time (non-negative; streams are sorted).
      inst: the job plus its *demanded* resource shape — ``inst.n_racks``
        / ``inst.n_wireless`` are what the job asks for; the cluster may
        grant less (a residual-capacity view) at admission time.
      job_id: position in the stream (0-based, unique per stream).
      family: workload family tag (for metrics breakdowns).
      deadline: absolute completion deadline, or ``None`` (best-effort).
      tenant: owning-tenant tag, or ``None`` (anonymous).
      tier: SLO tier name, or ``None`` (untiered).

    The three SLO fields default to ``None`` so pre-existing streams and
    pickles are unchanged; :func:`stream_tiered_arrivals` fills them in.
    """

    time: float
    inst: ProblemInstance
    job_id: int
    family: str
    deadline: float | None = None
    tenant: str | None = None
    tier: str | None = None


@dataclasses.dataclass(frozen=True)
class SloTier:
    """One SLO class in a tiered workload mix.

    Attributes:
      name: tier tag stamped on ``ArrivalEvent.tier``.
      weight: sampling weight in the tier mix (normalized internally).
      slack: deadline slack multiplier — a job's deadline is
        ``arrival + slack * lower_bound(inst)`` where ``lower_bound`` is
        the rigorous critical-path bound (so ``slack < 1`` is unmeetable
        by construction). ``None`` means best-effort: no deadline.
      share: weighted-fairness share used by ``admission="wfair"``
        (larger = more service per unit of attained work).
    """

    name: str
    weight: float
    slack: float | None
    share: float = 1.0


# Default three-class mix: a small latency-critical gold class with tight
# deadlines, a silver bulk class with loose deadlines, and a best-effort
# bronze class with none. Shares follow the usual 4:2:1 weighted-fair split.
DEFAULT_SLO_TIERS = (
    SloTier("gold", weight=0.2, slack=2.0, share=4.0),
    SloTier("silver", weight=0.5, slack=4.0, share=2.0),
    SloTier("bronze", weight=0.3, slack=None, share=1.0),
)


def _sorted_events(events: list[ArrivalEvent]) -> list[ArrivalEvent]:
    events.sort(key=lambda e: (e.time, e.job_id))
    return events


def _sample_family_job(
    rng: np.random.Generator, family: str, n_tasks: int, rho: float
) -> DagJob:
    """One job of ``family`` with ~``n_tasks`` tasks (§V fan-out shapes)."""
    if family == "simple_mapreduce":
        return make_simple_mapreduce(rng, n_map=max(1, n_tasks - 1), rho=rho)
    if family == "onestage_mapreduce":
        n_map = max(1, n_tasks // 2)
        return make_onestage_mapreduce(
            rng, n_map=n_map, n_reduce=max(1, n_tasks - n_map), rho=rho
        )
    if family == "random_workflow":
        return make_random_workflow(rng, n_tasks=n_tasks, rho=rho)
    raise ValueError(f"unknown family {family!r}")


def stream_poisson_arrivals(
    seed: int,
    rate: float,
    n_jobs: int,
    *,
    n_racks: int = 6,
    n_wireless: int = 2,
    rho: float = 0.5,
    families: Sequence[str] = JOB_FAMILIES,
    wired_rate: float = 1.0,
    wireless_rate: float = 1.0,
) -> Iterator[ArrivalEvent]:
    """Streaming form of :func:`poisson_arrivals`.

    Yields the same events, in the same (time-sorted) order, one at a
    time — arrival times are a cumulative sum of non-negative exponential
    gaps, so the generation order *is* the sorted order. Parameter
    validation happens eagerly at call time, not at first ``next()``.
    """
    if rate <= 0:
        raise ValueError("rate must be positive")

    def _gen() -> Iterator[ArrivalEvent]:
        rng = np.random.default_rng(seed)
        t = 0.0
        for j in range(n_jobs):
            t += float(rng.exponential(1.0 / rate))
            family = str(families[int(rng.integers(len(families)))])
            n_tasks = int(rng.integers(5, 11))
            job = _sample_family_job(rng, family, n_tasks, rho)
            inst = ProblemInstance(
                job=job,
                n_racks=n_racks,
                n_wireless=n_wireless,
                wired_rate=wired_rate,
                wireless_rate=wireless_rate,
            )
            yield ArrivalEvent(time=t, inst=inst, job_id=j, family=family)

    return _gen()


def poisson_arrivals(
    seed: int,
    rate: float,
    n_jobs: int,
    *,
    n_racks: int = 6,
    n_wireless: int = 2,
    rho: float = 0.5,
    families: Sequence[str] = JOB_FAMILIES,
    wired_rate: float = 1.0,
    wireless_rate: float = 1.0,
) -> list[ArrivalEvent]:
    """Seeded Poisson arrivals over the §V job families.

    Inter-arrival gaps are Exponential(``rate``) (``rate`` = expected jobs
    per unit time, on the same clock as task durations ~ U[1, 100]);
    each job is drawn uniformly from ``families`` with the paper's
    task-count range U[5, 10] and a fixed network factor ``rho``. Every
    job demands the full ``(n_racks, n_wireless)`` cluster shape.

    Returns a time-sorted list of :class:`ArrivalEvent`; same seed =>
    bit-identical stream. This is a ``list(...)`` wrapper over
    :func:`stream_poisson_arrivals`.
    """
    return _sorted_events(
        list(
            stream_poisson_arrivals(
                seed,
                rate,
                n_jobs,
                n_racks=n_racks,
                n_wireless=n_wireless,
                rho=rho,
                families=families,
                wired_rate=wired_rate,
                wireless_rate=wireless_rate,
            )
        )
    )


# §V production mix: MapReduce-style workflows dominate the trace, and a
# minority of shuffle-heavy jobs (rho >= 1) supplies the data-size tail.
PRODUCTION_FAMILY_WEIGHTS = {
    "simple_mapreduce": 0.45,
    "onestage_mapreduce": 0.35,
    "random_workflow": 0.20,
}
PRODUCTION_RHO_PALETTE = ((0.5, 0.55), (1.0, 0.30), (1.5, 0.15))


def production_arrivals(
    seed: int,
    rate: float,
    n_jobs: int,
    *,
    n_racks: int = 6,
    n_wireless: int = 2,
    min_rack_demand: int = 3,
    min_wireless_demand: int | None = None,
    wired_rate: float = 1.0,
    wireless_rate: float = 1.0,
) -> list[ArrivalEvent]:
    """The paper's §V production-scenario arrival mix.

    Poisson arrivals at ``rate`` whose jobs follow the production
    distributions: families weighted by
    :data:`PRODUCTION_FAMILY_WEIGHTS`, task counts U[5, 10] with
    family-specific fan-out (mappers = ``n_tasks - 1`` for simple
    MapReduce, a balanced map/reduce split for one-stage shuffles), and a
    per-job network factor drawn from :data:`PRODUCTION_RHO_PALETTE` —
    most jobs are compute-bound (rho 0.5) with a shuffle-heavy tail
    (rho 1.0 / 1.5) that stresses the shared channels. Each job demands
    between ``min_rack_demand`` and ``n_racks`` racks (uniform), so the
    cluster timeline has real packing decisions; wireless demand is the
    full ``n_wireless`` by default, or uniform in
    ``[min_wireless_demand, n_wireless]`` when that is given (not every
    production job uses the augmentation links — a spread of wireless
    demands is what gives exclusive subchannel grants, and backfilling
    around wireless-heavy head-of-line jobs, real packing decisions).

    Returns a time-sorted list of :class:`ArrivalEvent`; same seed =>
    bit-identical stream (the default ``min_wireless_demand=None`` draws
    nothing extra, so legacy streams are unchanged). This is a
    ``list(...)`` wrapper over :func:`stream_production_arrivals`.
    """
    return _sorted_events(
        list(
            stream_production_arrivals(
                seed,
                rate,
                n_jobs,
                n_racks=n_racks,
                n_wireless=n_wireless,
                min_rack_demand=min_rack_demand,
                min_wireless_demand=min_wireless_demand,
                wired_rate=wired_rate,
                wireless_rate=wireless_rate,
            )
        )
    )


def stream_production_arrivals(
    seed: int,
    rate: float,
    n_jobs: int,
    *,
    n_racks: int = 6,
    n_wireless: int = 2,
    min_rack_demand: int = 3,
    min_wireless_demand: int | None = None,
    wired_rate: float = 1.0,
    wireless_rate: float = 1.0,
) -> Iterator[ArrivalEvent]:
    """Streaming form of :func:`production_arrivals`.

    Yields the same events, in the same (time-sorted) order, one at a
    time, so arbitrarily long production traces cost O(1) memory in the
    generator. Parameter validation happens eagerly at call time.
    """
    if rate <= 0:
        raise ValueError("rate must be positive")
    if not 1 <= min_rack_demand <= n_racks:
        raise ValueError("min_rack_demand must be in [1, n_racks]")
    if min_wireless_demand is not None and not (
        0 <= min_wireless_demand <= n_wireless
    ):
        raise ValueError("min_wireless_demand must be in [0, n_wireless]")

    def _gen() -> Iterator[ArrivalEvent]:
        rng = np.random.default_rng(seed)
        fam_names = tuple(PRODUCTION_FAMILY_WEIGHTS)
        fam_p = np.asarray([PRODUCTION_FAMILY_WEIGHTS[f] for f in fam_names])
        fam_p = fam_p / fam_p.sum()
        rho_vals = np.asarray([v for v, _ in PRODUCTION_RHO_PALETTE])
        rho_p = np.asarray([w for _, w in PRODUCTION_RHO_PALETTE])
        rho_p = rho_p / rho_p.sum()

        t = 0.0
        for j in range(n_jobs):
            t += float(rng.exponential(1.0 / rate))
            family = str(fam_names[int(rng.choice(len(fam_names), p=fam_p))])
            rho = float(rho_vals[int(rng.choice(len(rho_vals), p=rho_p))])
            n_tasks = int(rng.integers(5, 11))
            job = _sample_family_job(rng, family, n_tasks, rho)
            demand = int(rng.integers(min_rack_demand, n_racks + 1))
            demand_w = (
                n_wireless
                if min_wireless_demand is None
                else int(rng.integers(min_wireless_demand, n_wireless + 1))
            )
            inst = ProblemInstance(
                job=job,
                n_racks=demand,
                n_wireless=demand_w,
                wired_rate=wired_rate,
                wireless_rate=wireless_rate,
            )
            yield ArrivalEvent(time=t, inst=inst, job_id=j, family=family)

    return _gen()


def _validated_tiers(tiers: Sequence[SloTier]) -> tuple[SloTier, ...]:
    tiers = tuple(tiers)
    if not tiers:
        raise ValueError("tiers must be non-empty")
    if any(t.weight < 0 for t in tiers) or not any(t.weight > 0 for t in tiers):
        raise ValueError("tier weights must be non-negative with positive sum")
    if any(t.slack is not None and t.slack <= 0 for t in tiers):
        raise ValueError("tier slack must be positive (or None for no deadline)")
    if any(t.share <= 0 for t in tiers):
        raise ValueError("tier share must be positive")
    return tiers


def stream_tiered_arrivals(
    events: Iterable[ArrivalEvent],
    seed: int,
    *,
    tiers: Sequence[SloTier] = DEFAULT_SLO_TIERS,
    n_tenants: int = 3,
) -> Iterator[ArrivalEvent]:
    """Annotate an arrival stream with seeded tenant + SLO-tier metadata.

    Each event draws a tenant uniformly from ``n_tenants`` and a tier from
    the ``tiers`` mix (weighted by :attr:`SloTier.weight`) using an RNG
    derived from ``(seed, "slo-tiers")`` — *not* the base stream's RNG —
    so the wrapped events carry identical ``time`` / ``inst`` / ``job_id``
    / ``family`` to the unwrapped stream. Tiers with finite slack stamp
    ``deadline = time + slack * lower_bound(inst)``; ``slack=None`` tiers
    leave ``deadline=None`` (best-effort).

    Lazily yields :class:`ArrivalEvent` copies, preserving input order.
    """
    tiers = _validated_tiers(tiers)
    if n_tenants < 1:
        raise ValueError("n_tenants must be >= 1")

    def _gen() -> Iterator[ArrivalEvent]:
        # Independent seed sequence: spawning off (seed, tag) keeps the tier
        # draws decoupled from the base stream's RNG consumption.
        rng = np.random.default_rng([seed, int.from_bytes(b"slo", "big")])
        p = np.asarray([t.weight for t in tiers], dtype=np.float64)
        p = p / p.sum()
        for ev in events:
            tier = tiers[int(rng.choice(len(tiers), p=p))]
            tenant = f"tenant-{int(rng.integers(n_tenants))}"
            deadline = (
                None
                if tier.slack is None
                else ev.time + tier.slack * lower_bound(ev.inst)
            )
            yield dataclasses.replace(
                ev, deadline=deadline, tenant=tenant, tier=tier.name
            )

    return _gen()


def tiered_poisson_arrivals(
    seed: int,
    rate: float,
    n_jobs: int,
    *,
    tiers: Sequence[SloTier] = DEFAULT_SLO_TIERS,
    n_tenants: int = 3,
    **kwargs,
) -> list[ArrivalEvent]:
    """:func:`poisson_arrivals` with tenant/SLO annotations.

    The base stream is bit-identical to ``poisson_arrivals(seed, ...)``
    (same times, DAGs, demands); only the SLO fields differ from ``None``.
    Extra ``kwargs`` pass through to the base generator.
    """
    return list(
        stream_tiered_arrivals(
            stream_poisson_arrivals(seed, rate, n_jobs, **kwargs),
            seed,
            tiers=tiers,
            n_tenants=n_tenants,
        )
    )


def tiered_production_arrivals(
    seed: int,
    rate: float,
    n_jobs: int,
    *,
    tiers: Sequence[SloTier] = DEFAULT_SLO_TIERS,
    n_tenants: int = 3,
    **kwargs,
) -> list[ArrivalEvent]:
    """:func:`production_arrivals` with tenant/SLO annotations.

    Same contract as :func:`tiered_poisson_arrivals`: the underlying
    production stream is bit-identical to the untiered one.
    """
    return list(
        stream_tiered_arrivals(
            stream_production_arrivals(seed, rate, n_jobs, **kwargs),
            seed,
            tiers=tiers,
            n_tenants=n_tenants,
        )
    )


def trace_arrivals(
    times: Iterable[float],
    jobs: Iterable[DagJob],
    *,
    n_racks: int = 6,
    n_wireless: int = 2,
    wired_rate: float = 1.0,
    wireless_rate: float = 1.0,
) -> list[ArrivalEvent]:
    """Trace-driven arrivals: replay explicit ``(time, job)`` pairs.

    ``times`` need not be pre-sorted (the stream is sorted, stably by
    input order on ties) but must be non-negative and match ``jobs`` in
    length. Every job demands the full cluster shape; wrap the result to
    override per-job demands.
    """
    times = [float(t) for t in times]
    jobs = list(jobs)
    if len(times) != len(jobs):
        raise ValueError("times and jobs must have the same length")
    if times and min(times) < 0.0:
        raise ValueError("arrival times must be non-negative")
    events = [
        ArrivalEvent(
            time=t,
            inst=ProblemInstance(
                job=job,
                n_racks=n_racks,
                n_wireless=n_wireless,
                wired_rate=wired_rate,
                wireless_rate=wireless_rate,
            ),
            job_id=j,
            family=job.name,
        )
        for j, (t, job) in enumerate(zip(times, jobs))
    ]
    return _sorted_events(events)


# -- seeded link outage traces -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkEvent:
    """One wireless-link state flip in an outage trace.

    Attributes:
      time: absolute event time (traces are sorted by time).
      rack: physical rack id of the flapping link.
      subchannel: physical wireless subchannel index (0-based).
      up: new link state — ``False`` = outage, ``True`` = repair.
    """

    time: float
    rack: int
    subchannel: int
    up: bool


def link_outage_trace(
    seed: int,
    n_racks: int,
    n_wireless: int,
    horizon: float,
    *,
    outage_rate: float = 0.02,
    mean_downtime: float = 10.0,
) -> list[LinkEvent]:
    """Seeded two-state link flap trace for a reconfigurable topology.

    Every (rack, subchannel) link alternates between up and down phases:
    up phases last ``Exp(1 / outage_rate)`` (so ``outage_rate`` is the
    per-link failure rate per time unit) and down phases
    ``Exp(mean_downtime)``. Events past ``horizon`` are dropped; a link
    down at the horizon simply stays down. Uses its own derived RNG
    (``(seed, "flap")``), so composing a trace with any arrival stream
    of the same seed leaves the arrivals bit-identical.

    The online service applies events with ``time <= epoch`` to the
    cluster's link state and folds the active-link fingerprint into the
    availability signature, so ``replan="changed"`` re-solves exactly the
    jobs whose plans a flap invalidates.

    Returns the events sorted by ``(time, rack, subchannel)``.
    """
    if n_racks < 1 or n_wireless < 0:
        raise ValueError("need n_racks >= 1 and n_wireless >= 0")
    if outage_rate < 0 or mean_downtime < 0:
        raise ValueError("outage_rate and mean_downtime must be >= 0")
    events: list[LinkEvent] = []
    if outage_rate == 0.0 or horizon <= 0.0:
        return events
    rng = np.random.default_rng([seed, int.from_bytes(b"flap", "big")])
    for i in range(n_racks):
        for k in range(n_wireless):
            t = 0.0
            while True:
                t += float(rng.exponential(1.0 / outage_rate))
                if t >= horizon:
                    break
                events.append(LinkEvent(t, i, k, False))
                t += float(rng.exponential(mean_downtime))
                if t >= horizon:
                    break
                events.append(LinkEvent(t, i, k, True))
    events.sort(key=lambda e: (e.time, e.rack, e.subchannel))
    return events
