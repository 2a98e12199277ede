# Copied from src/repro/core/coflow.py; imports retargeted to repro_torch.
"""Coflow view of an admission epoch and cross-job commit-order search.

The paper's model (and our engine) optimizes each job's *intra-job*
decisions — task->rack assignment, per-transfer channel choice — but the
online service commits one epoch's admitted jobs in queue (FIFO) order,
and the commit order is exactly the cross-job priority on the shared
wired channel: a job committed earlier gap-inserts its transfers first
and everyone after it queues around them. That order is a free
optimization dimension the per-job solver never sees.

This module treats it as a coflow scheduling problem. Each admitted
job's transfer set is one :class:`Coflow` — its aggregate busy-time
demand on every *shared* physical resource (the wired channel, plus each
granted wireless subchannel) — and the epoch's batch is scheduled as a
set of coflows:

* :func:`sigma_order` — a Sincronia-style bottleneck-first ordering
  ("Near Optimal Coflow Scheduling in Networks", PAPERS.md): repeatedly
  find the most-loaded shared resource and place *last* the remaining
  coflow with the largest demand on it. With one shared resource (the
  common case here: co-admitted jobs' rack and subchannel grants are
  disjoint, so only the wired channel is contended inside an epoch) this
  degenerates to shortest-demand-first, the 2-approximation ordering for
  total completion time on a single shared link.
* :func:`search_commit_order` — a deterministic permutation-neighborhood
  search over commit orders, driven by the existing
  :class:`~repro_torch.core.portfolio.Portfolio` allocator: the registered
  arbitration strategies (:class:`OrderSwapStrategy`,
  :class:`OrderInsertStrategy`) propose permutations of the incumbent
  order, each unique order is evaluated once through the caller's
  replay, and FIFO is always evaluated first — the returned order is
  never worse than FIFO under the caller's objective. Batches of at most
  ``exhaustive_max`` jobs are solved exactly by enumerating every
  permutation (the oracle regime the test layer locks).

The evaluation itself lives with the owner of the cluster state
(:func:`repro_torch.online.cluster.replay_commit_order` replays a candidate
order through the host simulator's ``channel_busy`` hook); this module
is pure search and never touches a timeline.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Mapping, Sequence

import numpy as np

from repro_torch.core.instance import CH_WIRED, ProblemInstance
from repro_torch.core.portfolio import (
    ARBITRATION_STRATEGIES,
    Portfolio,
    SearchView,
    StrategyBase,
    register_arbitration_strategy,
)
from repro_torch.core.schedule import Schedule

__all__ = [
    "Coflow",
    "OrderInsertStrategy",
    "OrderSearchResult",
    "OrderSwapStrategy",
    "WIRED",
    "DEFAULT_ORDER_PORTFOLIO",
    "build_order_strategies",
    "coflow_from_instance",
    "coflow_from_schedule",
    "search_commit_order",
    "sigma_order",
    "wireless_resource",
]

# Shared-resource keys. The wired channel is one global resource; each
# wireless subchannel is keyed by its *physical* index so demands from
# different jobs' local channel labels land on the same key.
WIRED = "wired"


def wireless_resource(phys: int) -> str:
    """Resource key of physical wireless subchannel ``phys``."""
    return f"wireless:{int(phys)}"


@dataclasses.dataclass(frozen=True)
class Coflow:
    """One job's aggregate transfer demand on the shared resources.

    Attributes:
      index: the job's position in the epoch batch (its FIFO rank).
      job_id: stream job id (labels only; -1 when unknown).
      demand: busy-time demanded per shared resource key
        (:data:`WIRED` / :func:`wireless_resource`); zero-demand
        resources are omitted.
    """

    index: int
    job_id: int
    demand: Mapping[str, float]

    @property
    def total(self) -> float:
        """Total busy-time across every shared resource."""
        return float(sum(self.demand.values()))


def coflow_from_schedule(
    view, sched: Schedule, *, index: int, job_id: int = -1
) -> Coflow:
    """Coflow of one *solved* job: exact per-resource busy time of the
    schedule's transfers (wired edges on :data:`WIRED`, wireless edges on
    their physical subchannel via ``view.wireless_map``). Local traffic
    occupies no shared resource and is ignored."""
    inst = view.inst
    demand: dict[str, float] = {}
    if inst.job.n_edges:
        dur = inst.duration_on(sched.chan)
        for e in range(inst.job.n_edges):
            d = float(dur[e])
            if d <= 0.0:
                continue
            c = int(sched.chan[e])
            if c == CH_WIRED:
                key = WIRED
            elif c >= 2:
                key = wireless_resource(int(view.wireless_map[c - 2]))
            else:
                continue  # local: private to the rack, never shared
            demand[key] = demand.get(key, 0.0) + d
    return Coflow(index=int(index), job_id=int(job_id), demand=demand)


def coflow_from_instance(
    inst: ProblemInstance, *, index: int, job_id: int = -1
) -> Coflow:
    """Coflow of one *unsolved* job: a placement-free proxy charging the
    job's whole transfer volume to the wired channel at the wired rate
    (the worst case — any transfer the eventual placement keeps local or
    moves to wireless only shrinks the true wired demand). Used for
    baseline policies, whose schedules are solved lazily at commit time
    so exact per-resource demands do not exist yet."""
    total = float(np.sum(inst.q_wired)) if inst.job.n_edges else 0.0
    demand = {WIRED: total} if total > 0.0 else {}
    return Coflow(index=int(index), job_id=int(job_id), demand=demand)


def sigma_order(coflows: Sequence[Coflow]) -> list[int]:
    """Sincronia-style bottleneck-first ordering of one epoch's coflows.

    Repeatedly: find the most-loaded shared resource (the bottleneck),
    schedule *last* the remaining coflow with the largest demand on it,
    and recurse on the rest. Coflows with no shared-resource demand at
    all keep their FIFO rank at the front (they cannot contend). Ties are
    deterministic: the bottleneck is the lexicographically smallest
    max-load resource, and among equal-demand coflows the latest FIFO
    rank goes last — so an all-equal batch returns pure FIFO.

    Returns the batch positions (``Coflow.index``) in commit order,
    first-to-commit first.
    """
    remaining = list(coflows)
    suffix: list[Coflow] = []  # chosen back-to-front
    while remaining:
        load: dict[str, float] = {}
        for c in remaining:
            for key, d in c.demand.items():
                if d > 0.0:
                    load[key] = load.get(key, 0.0) + d
        if not load:
            break  # only demand-free coflows left: they head the order
        peak = max(load.values())
        bottleneck = min(k for k, v in load.items() if v == peak)
        last = max(
            (c for c in remaining if c.demand.get(bottleneck, 0.0) > 0.0),
            key=lambda c: (c.demand[bottleneck], c.index),
        )
        suffix.append(last)
        remaining.remove(last)
    head = sorted(remaining, key=lambda c: c.index)
    return [c.index for c in head] + [c.index for c in reversed(suffix)]


# -- permutation-neighborhood strategies --------------------------------------


class _OrderStrategyBase(StrategyBase):
    """Arbitration strategies perturb the incumbent *commit order*
    (``view.best_rack`` is an int32 permutation of ``range(n_jobs)``).
    Shared helper: draw two distinct positions from the view's RNG."""

    @staticmethod
    def _two_positions(rng: np.random.Generator, n: int) -> tuple[int, int]:
        a = int(rng.integers(0, n))
        b = int(rng.integers(0, n - 1))
        return a, b + 1 if b >= a else b


@register_arbitration_strategy
class OrderSwapStrategy(_OrderStrategyBase):
    """Transposition neighborhood: swap two distinct positions of the
    incumbent commit order."""

    name = "order_swap"

    def propose(self, view: SearchView, count: int) -> np.ndarray:
        base = np.asarray(view.best_rack, dtype=np.int32)
        n = base.shape[0]
        out = np.tile(base, (count, 1))
        for r in range(count):
            a, b = self._two_positions(view.rng, n)
            out[r, a], out[r, b] = out[r, b], out[r, a]
        return out


@register_arbitration_strategy
class OrderInsertStrategy(_OrderStrategyBase):
    """Reinsertion neighborhood: remove one job from the incumbent order
    and reinsert it at another position (shifting the span between — the
    natural move when one job should jump the queue entirely)."""

    name = "order_insert"

    def propose(self, view: SearchView, count: int) -> np.ndarray:
        base = np.asarray(view.best_rack, dtype=np.int32)
        n = base.shape[0]
        out = np.empty((count, n), dtype=np.int32)
        for r in range(count):
            a, b = self._two_positions(view.rng, n)
            row = np.delete(base, a)
            out[r] = np.insert(row, b, base[a])
        return out


DEFAULT_ORDER_PORTFOLIO = ("order_swap", "order_insert")


def build_order_strategies(spec=None) -> list:
    """Resolve an arbitration-strategy spec into fresh Strategy objects.

    ``spec`` may be ``None`` (:data:`DEFAULT_ORDER_PORTFOLIO`), a single
    registry name, or a sequence of registry names / zero-arg factories /
    live Strategy objects — the same shapes
    :func:`repro_torch.core.portfolio.build_strategies` accepts, resolved
    against :data:`~repro_torch.core.portfolio.ARBITRATION_STRATEGIES`.
    """
    if spec is None:
        spec = DEFAULT_ORDER_PORTFOLIO
    elif isinstance(spec, str):
        spec = (spec,)
    out = []
    for item in spec:
        if isinstance(item, str):
            if item not in ARBITRATION_STRATEGIES:
                raise ValueError(
                    f"unknown arbitration strategy {item!r}; "
                    f"registry: {sorted(ARBITRATION_STRATEGIES)}"
                )
            out.append(ARBITRATION_STRATEGIES[item]())
        elif isinstance(item, type) or (
            callable(item) and not hasattr(item, "propose")
        ):
            out.append(item())
        elif hasattr(item, "propose"):
            out.append(item)
        else:
            raise TypeError(f"not a strategy, factory, or name: {item!r}")
    names = [s.name for s in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate strategy names in order portfolio: {names}")
    return out


# -- order search -------------------------------------------------------------


def _scalar(obj) -> float:
    """Portfolio-accounting scalar of an order objective. Objectives are
    either a plain float or a ``(n_rejected, total_jct)`` tuple — the
    tuple is folded rejection-dominant so the allocator's improvement
    credits line up with the driver's lexicographic comparisons."""
    if isinstance(obj, tuple):
        rejected, total = obj
        return float(rejected) * 1e12 + float(total)
    return float(obj)


@dataclasses.dataclass(frozen=True)
class OrderSearchResult:
    """Outcome of one :func:`search_commit_order` call.

    Attributes:
      order: best commit order found (batch positions, first-first).
      objective: its objective, as returned by the caller's ``evaluate``.
      fifo_objective: the FIFO order's objective — always evaluated, so
        ``objective <= fifo_objective`` holds by construction.
      n_evals: unique orders evaluated (duplicates are cached).
      exhaustive: True when every permutation was enumerated (the result
        is the oracle optimum of ``evaluate``).
    """

    order: tuple[int, ...]
    objective: object
    fifo_objective: object
    n_evals: int
    exhaustive: bool


def search_commit_order(
    evaluate: Callable[[tuple[int, ...]], object],
    n: int,
    *,
    rng: np.random.Generator,
    seeds: Sequence[Sequence[int]] = (),
    rounds: int = 2,
    pool_size: int = 8,
    strategies=None,
    exhaustive_max: int = 3,
) -> OrderSearchResult:
    """Search the space of commit permutations of an ``n``-job batch.

    ``evaluate(order)`` scores one full commit order (lower is better;
    any ``<``-comparable value works — the online service returns
    ``(n_rejected, total_jct)`` tuples). Each unique order is evaluated
    at most once. FIFO (``(0, 1, ..., n-1)``) is always evaluated first
    and only *strictly* better orders replace it, so the result is never
    worse than FIFO under ``evaluate`` — the invariant the oracle test
    layer locks.

    Batches with ``n <= exhaustive_max`` enumerate every permutation and
    return the exact optimum. Larger batches evaluate the ``seeds``
    (e.g. the sigma ordering), then run ``rounds`` rounds of the
    :class:`~repro_torch.core.portfolio.Portfolio` allocator over the
    registered permutation neighborhoods, ``pool_size`` proposals per
    round. Deterministic for a fixed ``rng`` state.
    """
    if n < 1:
        raise ValueError("need at least one job to order")
    identity = list(range(n))
    cache: dict[tuple[int, ...], object] = {}

    def ev(order) -> tuple[tuple[int, ...], object]:
        key = tuple(int(x) for x in order)
        if sorted(key) != identity:
            raise ValueError(f"not a permutation of range({n}): {key}")
        if key not in cache:
            cache[key] = evaluate(key)
        return key, cache[key]

    fifo = tuple(identity)
    _, fifo_obj = ev(fifo)
    best, best_obj = fifo, fifo_obj
    if n <= exhaustive_max:
        for perm in itertools.permutations(identity):
            key, obj = ev(perm)
            if obj < best_obj:
                best, best_obj = key, obj
        return OrderSearchResult(best, best_obj, fifo_obj, len(cache), True)
    for seed_order in seeds:
        key, obj = ev(seed_order)
        if obj < best_obj:
            best, best_obj = key, obj
    # Portfolio-driven neighborhood search. The driver's `inst` is only
    # ever handed to strategies through the SearchView; order strategies
    # need no instance, so none is attached.
    driver = Portfolio(
        build_order_strategies(strategies), None, rng, pool_size=int(pool_size)
    )
    for _ in range(max(0, int(rounds))):
        incumbent_scalar = _scalar(best_obj)
        pool, tags = driver.begin_round(
            np.asarray(best, dtype=np.int32), incumbent_scalar
        )
        if pool.shape[0] == 0:
            break
        vals = np.empty(pool.shape[0], dtype=np.float64)
        for r in range(pool.shape[0]):
            key, obj = ev(pool[r])
            vals[r] = _scalar(obj)
            if obj < best_obj:
                best, best_obj = key, obj
        driver.observe(tags, pool, vals, prev_best=incumbent_scalar)
        driver.end_round(np.asarray(best, dtype=np.int32), _scalar(best_obj))
    return OrderSearchResult(best, best_obj, fifo_obj, len(cache), False)
