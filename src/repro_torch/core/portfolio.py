# Copied from src/repro/core/portfolio.py; imports retargeted to repro_torch.
"""Metaheuristic search portfolio for the refinement stage (beyond-paper).

The paper's B&B attains optimality because its §IV-A bounds focus the
search; the vectorized engine's sampled regime instead relies on a
refinement loop to close the gap, and a single neighborhood (mutation
local search) stalls on dense instances. This module turns that loop into
a **portfolio** of pluggable strategies sharing one candidate budget:

  * :class:`MutationStrategy` — the PR 2 local search (single-task
    resamples, edge co-locations, rack swaps around the incumbent).
  * :class:`CrossoverStrategy` — elite recombination: uniform crossover
    between two distinct members of the per-instance elite pool, with a
    rack-count feasibility repair on the children.
  * :class:`AnnealingStrategy` — simulated annealing: a walker proposes
    mutations of *its own* state (not the incumbent) and accepts worse
    rounds with temperature-scheduled Metropolis probability, so it can
    tunnel out of the basins where plain local search stalls.

The :class:`Portfolio` driver allocates each round's batch budget across
strategies by **recent yield** (incumbent improvement per evaluated
candidate, multiplicative-weights style) and runs *inside* the lockstep
fleet driver of :mod:`repro_torch.core.vectorized`: every strategy's proposals
ride the same mega-batch launches, pass the same fused §IV-A stage-1
pruner, and are scored by the one compiled stage-2 evaluator. Per-strategy
proposed/pruned/evaluated/improved counters and final weights surface in
``VectorizedResult.strategy_stats`` / ``FleetResult.strategy_stats``.

Determinism contract
--------------------
All randomness flows through the single per-instance refinement generator
(``np.random.default_rng(seed + 1)``), consumed in a fixed order each
round: strategies propose in portfolio order, then end-of-round hooks run
in the same order. Fixed seed + fixed strategy list => bit-identical
results across runs and across fleet packings. With the default
single-strategy spec ``("mutation",)`` the RNG call sequence is exactly
the pre-portfolio refinement loop's, so results reproduce it bit-for-bit.

Authoring a new strategy: see :class:`Strategy` and
``docs/architecture.md`` ("Writing a new strategy").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.instance import ProblemInstance

__all__ = [
    "Strategy",
    "StrategyBase",
    "SearchView",
    "StrategyStats",
    "ElitePool",
    "MutationStrategy",
    "CrossoverStrategy",
    "AnnealingStrategy",
    "Portfolio",
    "STRATEGIES",
    "ARBITRATION_STRATEGIES",
    "DEFAULT_PORTFOLIO",
    "build_strategies",
    "register_arbitration_strategy",
    "spec_length",
    "merge_strategy_stats",
    "mutate_pool",
    "stats_snapshot",
]


def mutate_pool(
    rng: np.random.Generator,
    best: np.ndarray,
    inst: ProblemInstance,
    count: int,
) -> np.ndarray:
    """Seeded local-search mutations of one assignment (the PR 2 kernel).

    Mix of single-task resamples, co-locations along DAG edges (move the two
    endpoints of a transfer onto one rack), and rack swaps between two tasks.

    Args:
      rng: generator consumed in a fixed call order (determinism contract).
      best: int[n_tasks] assignment to perturb.
      inst: the instance (rack count and DAG edges drive the moves).
      count: number of candidates to emit.

    Returns:
      int32[count, n_tasks] candidate assignments.
    """
    n, M = best.shape[0], inst.n_racks
    pool = np.tile(best.astype(np.int32), (count, 1))
    kind = rng.integers(0, 3, size=count)
    edges = inst.job.edges
    for i in range(count):
        if kind[i] == 0 or edges.shape[0] == 0:
            # Resample 1-2 random coordinates.
            for v in rng.integers(0, n, size=int(rng.integers(1, 3))):
                pool[i, v] = rng.integers(0, M)
        elif kind[i] == 1:
            e = int(rng.integers(0, edges.shape[0]))
            u, v = int(edges[e, 0]), int(edges[e, 1])
            pool[i, v] = pool[i, u]
        else:
            u, v = rng.integers(0, n, size=2)
            pool[i, u], pool[i, v] = pool[i, v], pool[i, u]
    return pool


class ElitePool:
    """Best distinct assignments seen so far, sorted best-first.

    Fed from every scored block (sweep and refinement); insertion is
    deterministic (stable ties: earlier entrants keep their rank) and
    duplicates are dropped by exact assignment equality, so the pool stays
    diverse enough for crossover to recombine.
    """

    def __init__(self, capacity: int = 16):
        self.capacity = capacity
        self.vals: list[float] = []
        self.racks: list[np.ndarray] = []
        self._keys: set[bytes] = set()

    def __len__(self) -> int:
        return len(self.racks)

    def add(self, rack: np.ndarray, val: float) -> None:
        rack = np.asarray(rack, dtype=np.int32)
        key = rack.tobytes()
        if key in self._keys:
            return
        if len(self.racks) >= self.capacity:
            if val >= self.vals[-1]:
                return
            worst = self.racks.pop()
            self.vals.pop()
            self._keys.discard(worst.tobytes())
        # Stable: a new entry goes after equal-valued incumbents.
        i = int(np.searchsorted(np.asarray(self.vals), val, side="right"))
        self.vals.insert(i, float(val))
        self.racks.insert(i, rack.copy())
        self._keys.add(key)

    def add_batch(self, racks: np.ndarray, vals: np.ndarray) -> None:
        """Offer a scored block; only the block's best ``capacity`` rows can
        possibly enter, so insertion cost stays O(capacity log B) per block."""
        if racks.shape[0] == 0:
            return
        order = np.argsort(vals, kind="stable")[: self.capacity]
        for j in order:
            self.add(racks[j], float(vals[j]))


@dataclasses.dataclass
class SearchView:
    """Read-only snapshot a strategy sees when proposing/observing.

    Attributes:
      inst: the problem instance being refined.
      rng: the shared per-instance generator (consume deterministically!).
      best_rack: int[n_tasks] current incumbent assignment.
      best_val: incumbent greedy makespan (float32-accurate).
      elites: the per-instance :class:`ElitePool`.
      round_index: 0-based refinement round.
    """

    inst: ProblemInstance
    rng: np.random.Generator
    best_rack: np.ndarray
    best_val: float
    elites: ElitePool
    round_index: int


@runtime_checkable
class Strategy(Protocol):
    """One member of the refinement portfolio.

    A strategy is a *candidate generator with memory*: each round the
    portfolio asks it to ``propose`` a block of assignments, routes the
    block through the shared stage-1 pruner and stage-2 evaluator, and
    feeds the scored survivors back via ``observe``/``end_round``.

    Contract:
      * ``name``: unique identifier; keys the ``strategy_stats`` counters.
      * ``propose(view, count) -> int32[count, n_tasks]`` with every entry
        in ``[0, view.inst.n_racks)``. Must draw randomness only from
        ``view.rng`` (the determinism contract).
      * ``observe(view, racks, vals)``: scored survivors of *this
        strategy's* proposals (pruned rows never appear). Optional hook —
        update internal state only; the incumbent is driver-owned.
      * ``end_round(view)``: called once per round after all blocks are
        scored, in portfolio order; ``view`` holds the post-round
        incumbent. Optional hook.

    The driver applies incumbent updates itself and only ever *improves*
    the incumbent, so a strategy (annealing included) can never make the
    returned result worse than its input.
    """

    name: str

    def propose(self, view: SearchView, count: int) -> np.ndarray: ...

    def observe(self, view: SearchView, racks: np.ndarray, vals: np.ndarray) -> None: ...

    def end_round(self, view: SearchView) -> None: ...


class StrategyBase:
    """No-op ``observe``/``end_round`` so minimal strategies only write
    ``name`` and ``propose``."""

    name = "base"

    def observe(self, view: SearchView, racks: np.ndarray, vals: np.ndarray) -> None:
        return None

    def end_round(self, view: SearchView) -> None:
        return None


class MutationStrategy(StrategyBase):
    """The PR 2 local search: mutate the incumbent with :func:`mutate_pool`.

    With a single-strategy portfolio this reproduces the pre-portfolio
    refinement loop bit-for-bit (same RNG call sequence, same pool size).
    """

    name = "mutation"

    def propose(self, view: SearchView, count: int) -> np.ndarray:
        return mutate_pool(view.rng, view.best_rack, view.inst, count)


class CrossoverStrategy(StrategyBase):
    """Elite recombination: uniform crossover between two distinct elites.

    Each child copies every task's rack from one of two distinct parents
    drawn from the elite pool (coordinate-wise coin flips), then passes a
    rack-count feasibility repair: any label outside ``[0, n_racks)`` is
    folded back with a modulo (parents from the same instance already
    satisfy this, so the repair guards only externally injected elites).
    Falls back to incumbent mutation until the pool has two members.
    """

    name = "crossover"

    def propose(self, view: SearchView, count: int) -> np.ndarray:
        elites = view.elites
        if len(elites) < 2:
            return mutate_pool(view.rng, view.best_rack, view.inst, count)
        E = len(elites)
        n = view.best_rack.shape[0]
        rng = view.rng
        a = rng.integers(0, E, size=count)
        b = rng.integers(0, E - 1, size=count)
        b = np.where(b >= a, b + 1, b)  # force distinct parents
        parents = np.stack(elites.racks, axis=0)  # int32[E, n]
        mask = rng.random((count, n)) < 0.5
        child = np.where(mask, parents[a], parents[b]).astype(np.int32)
        M = view.inst.n_racks
        bad = (child < 0) | (child >= M)
        if bad.any():
            child[bad] = np.abs(child[bad]) % M
        return child


class AnnealingStrategy(StrategyBase):
    """Simulated annealing on a walker seeded from the incumbent.

    The walker proposes mutations of its *own* state. At end of round the
    best scored proposal replaces the walker if it improves it, else with
    Metropolis probability ``exp(-delta / T)``; ``T`` starts at
    ``t0_frac * incumbent`` and decays by ``alpha`` per round. Because the
    walker — not the incumbent — absorbs the worse moves, the strategy
    explores distant basins while the driver's strict-improvement rule
    keeps the returned incumbent monotone.

    Args:
      t0_frac: initial temperature as a fraction of the starting incumbent.
      alpha: geometric cooling factor per round, in (0, 1].
    """

    name = "annealing"

    def __init__(self, t0_frac: float = 0.25, alpha: float = 0.85):
        self.t0_frac = float(t0_frac)
        self.alpha = float(alpha)
        self._walker: np.ndarray | None = None
        self._walker_val = math.inf
        self._temp = 0.0
        self._round_best: np.ndarray | None = None
        self._round_best_val = math.inf

    def propose(self, view: SearchView, count: int) -> np.ndarray:
        if self._walker is None:
            self._walker = np.asarray(view.best_rack, dtype=np.int32).copy()
            self._walker_val = float(view.best_val)
            self._temp = max(self.t0_frac * float(view.best_val), 1e-9)
        self._round_best = None
        self._round_best_val = math.inf
        return mutate_pool(view.rng, self._walker, view.inst, count)

    def observe(self, view: SearchView, racks: np.ndarray, vals: np.ndarray) -> None:
        j = int(np.argmin(vals))
        if float(vals[j]) < self._round_best_val:
            self._round_best_val = float(vals[j])
            self._round_best = np.asarray(racks[j], dtype=np.int32).copy()

    def end_round(self, view: SearchView) -> None:
        if self._walker is None:
            return
        if self._round_best is not None:
            delta = self._round_best_val - self._walker_val
            if delta <= 0.0 or view.rng.random() < math.exp(
                -delta / max(self._temp, 1e-12)
            ):
                self._walker = self._round_best
                self._walker_val = self._round_best_val
        # Consume the round's candidate either way: a round in which the
        # allocator gave this strategy no proposals must neither re-judge a
        # stale candidate nor draw from the RNG.
        self._round_best = None
        self._round_best_val = math.inf
        self._temp *= self.alpha


@dataclasses.dataclass
class StrategyStats:
    """Per-strategy refinement counters (one entry per portfolio member).

    Attributes:
      proposed: candidates the strategy emitted.
      pruned: proposals discarded by the stage-1 §IV-A bound.
      evaluated: proposals scored by the stage-2 evaluator.
      improved: scored proposals that beat the incumbent at score time.
      improvement: total incumbent decrease credited to the strategy
        (sum over rounds of ``max(0, round_start_best - round_min)``).
      weight: final multiplicative weight in the allocator.
    """

    proposed: int = 0
    pruned: int = 0
    evaluated: int = 0
    improved: int = 0
    improvement: float = 0.0
    weight: float = 1.0

    @property
    def yield_per_eval(self) -> float:
        """Improvement per evaluated candidate — the allocator's signal."""
        return self.improvement / self.evaluated if self.evaluated else 0.0


def stats_snapshot(stats: dict[str, StrategyStats]) -> dict[str, dict]:
    """Plain-dict snapshot of per-strategy counters, sorted by name.

    The trace layer attaches this to its ``portfolio_yields`` decision
    events — JSON-serializable, no live :class:`StrategyStats` refs.
    """
    return {
        name: {
            "proposed": s.proposed,
            "pruned": s.pruned,
            "evaluated": s.evaluated,
            "improved": s.improved,
            "improvement": s.improvement,
            "weight": s.weight,
            "yield_per_eval": s.yield_per_eval,
        }
        for name, s in sorted(stats.items())
    }


def merge_strategy_stats(
    stats_dicts: Iterable[dict[str, StrategyStats]],
) -> dict[str, StrategyStats]:
    """Aggregate per-instance stats into fleet totals (weights averaged)."""
    out: dict[str, StrategyStats] = {}
    weights: dict[str, list[float]] = {}
    for d in stats_dicts:
        for name, s in d.items():
            agg = out.setdefault(name, StrategyStats(weight=0.0))
            agg.proposed += s.proposed
            agg.pruned += s.pruned
            agg.evaluated += s.evaluated
            agg.improved += s.improved
            agg.improvement += s.improvement
            weights.setdefault(name, []).append(s.weight)
    for name, ws in weights.items():
        out[name].weight = float(np.mean(ws))
    return out


STRATEGIES = {
    "mutation": MutationStrategy,
    "crossover": CrossoverStrategy,
    "annealing": AnnealingStrategy,
}

# Arbitration-order strategies: the same Strategy protocol, but proposals
# are int32[count, n_jobs] *commit permutations* of one admission epoch's
# batch instead of task->rack assignments (``view.best_rack`` holds the
# incumbent order; every row must be a permutation of ``range(n_jobs)``).
# A separate registry keeps the two search spaces from mixing — an
# assignment strategy in an order portfolio (or vice versa) would propose
# out-of-space rows. Members live in :mod:`repro_torch.core.coflow`, which
# registers them at import via :func:`register_arbitration_strategy`;
# the registry is defined here so the driver machinery (one
# :class:`Portfolio` per epoch) and both registries share one module.
ARBITRATION_STRATEGIES: dict[str, type] = {}


def register_arbitration_strategy(cls: type) -> type:
    """Class decorator: add an arbitration-order Strategy to the registry
    under its ``name`` (duplicate names raise — they would shadow)."""
    name = getattr(cls, "name", None)
    if not isinstance(name, str) or not name:
        raise ValueError(f"arbitration strategy {cls!r} needs a `name`")
    if name in ARBITRATION_STRATEGIES:
        raise ValueError(f"duplicate arbitration strategy name {name!r}")
    ARBITRATION_STRATEGIES[name] = cls
    return cls

# The full portfolio spec (the ``strategies="portfolio"`` alias).
DEFAULT_PORTFOLIO = ("mutation", "crossover", "annealing")


def _normalize_spec(spec) -> tuple:
    if spec is None:
        return ("mutation",)
    if isinstance(spec, str):
        if spec == "portfolio":
            return DEFAULT_PORTFOLIO
        return (spec,)
    return tuple(spec)


def spec_length(spec) -> int:
    """Number of strategies a spec resolves to (without instantiating)."""
    return len(_normalize_spec(spec))


def build_strategies(spec) -> list:
    """Resolve a strategy spec into fresh Strategy objects.

    ``spec`` may be ``None`` (the single-strategy ``("mutation",)`` default,
    which reproduces the pre-portfolio refinement loop bit-for-bit), the
    string ``"portfolio"`` (alias for :data:`DEFAULT_PORTFOLIO`), a single
    registry name, or a sequence whose elements are registry names
    (``"mutation"`` / ``"crossover"`` / ``"annealing"``), zero-arg factories
    returning a Strategy, or live Strategy objects (single-instance
    searches only — strategies are stateful, so a fleet must receive names
    or factories to get one private copy per instance).
    """
    out = []
    for item in _normalize_spec(spec):
        if isinstance(item, str):
            if item not in STRATEGIES:
                raise ValueError(
                    f"unknown strategy {item!r}; registry: {sorted(STRATEGIES)}"
                )
            out.append(STRATEGIES[item]())
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
        raise ValueError(f"duplicate strategy names in portfolio: {names}")
    return out


class Portfolio:
    """Yield-driven budget allocator over a set of strategies.

    One ``Portfolio`` instance drives the refinement of ONE problem
    instance inside the lockstep fleet driver
    (:func:`repro_torch.core.vectorized.schedule_fleet` constructs one per
    instance). Each round it:

      1. splits the round's candidate budget (``pool_size``) across
         strategies proportionally to their multiplicative weights (with a
         ``min_share`` exploration floor, largest-remainder rounding), and
         concatenates their proposals into one tagged block;
      2. receives pruning and scoring feedback row-by-row (``note_pruned``
         / ``observe``) as the fleet driver's shared launches complete;
      3. at ``end_round`` credits each strategy with
         ``max(0, round_start_best - round_min_strategy)`` improvement,
         converts credits to yields (improvement per evaluated candidate),
         and updates weights ``w *= exp(eta * yield / max_yield)``
         (multiplicative weights), clipped to keep every strategy alive.
         With ``yield_decay`` > 0 the update signal is a geometrically
         decayed running yield (``acc = yield_decay * acc + yield``) so a
         strategy's past rounds keep a fading vote; the update only fires
         on rounds whose *current* yields are non-zero (stalled rounds
         never re-apply stale evidence). The 0.0 default is memoryless
         and reproduces the plain update bit for bit.

    Determinism: weight arithmetic is pure float; the only randomness is
    the strategies' draws from the shared per-instance generator, in fixed
    portfolio order. With a single strategy the allocator is the identity
    (full budget, no weight dynamics), which is what makes the
    mutation-only portfolio reproduce the PR 2 loop bit-for-bit.
    """

    def __init__(
        self,
        strategies: Sequence,
        inst: ProblemInstance,
        rng: np.random.Generator,
        *,
        pool_size: int,
        eta: float = 2.0,
        min_share: float = 0.10,
        elite_capacity: int = 16,
        yield_decay: float = 0.0,
    ):
        self.strategies = list(strategies)
        if not self.strategies:
            raise ValueError("portfolio needs at least one strategy")
        self.inst = inst
        self.rng = rng
        self.pool_size = int(pool_size)
        self.eta = float(eta)
        self.min_share = float(min_share)
        self.yield_decay = float(yield_decay)
        if not 0.0 <= self.yield_decay < 1.0:
            raise ValueError("yield_decay must be in [0, 1)")
        self.elites = ElitePool(elite_capacity)
        k = len(self.strategies)
        self.weights = np.ones(k, dtype=np.float64)
        self._yield_acc = np.zeros(k, dtype=np.float64)
        self.stats = {s.name: StrategyStats() for s in self.strategies}
        self.round_index = 0
        self._view: SearchView | None = None
        self._round_min = np.full(k, np.inf)
        self._round_eval = np.zeros(k, dtype=np.int64)
        self._round_start_best = math.inf

    def _allocations(self) -> np.ndarray:
        k = len(self.strategies)
        if k == 1:
            return np.asarray([self.pool_size])
        share = self.weights / self.weights.sum()
        share = np.maximum(share, self.min_share)
        share = share / share.sum()
        counts = np.floor(share * self.pool_size).astype(np.int64)
        frac = share * self.pool_size - counts
        # Largest-remainder rounding, stable ties by portfolio order.
        for idx in np.argsort(-frac, kind="stable")[: self.pool_size - counts.sum()]:
            counts[idx] += 1
        return counts

    def _make_view(self, best_rack: np.ndarray, best_val: float) -> SearchView:
        return SearchView(
            inst=self.inst,
            rng=self.rng,
            best_rack=best_rack,
            best_val=best_val,
            elites=self.elites,
            round_index=self.round_index,
        )

    def begin_round(
        self, best_rack: np.ndarray, best_val: float
    ) -> tuple[np.ndarray, np.ndarray]:
        """Collect this round's proposals.

        Returns ``(pool, tags)``: int32[P, n_tasks] candidates and
        int32[P] per-row strategy indices (P == ``pool_size``).
        """
        self._view = self._make_view(best_rack, best_val)
        self._round_start_best = float(best_val)
        self._round_min[:] = np.inf
        self._round_eval[:] = 0
        counts = self._allocations()
        pools, tags = [], []
        n = int(np.asarray(best_rack).shape[0])
        for s_idx, (strat, c) in enumerate(zip(self.strategies, counts)):
            if c <= 0:
                continue
            block = np.asarray(strat.propose(self._view, int(c)), dtype=np.int32)
            if block.shape != (int(c), n):
                raise ValueError(
                    f"strategy {strat.name!r} proposed shape {block.shape}, "
                    f"expected {(int(c), n)}"
                )
            self.stats[strat.name].proposed += block.shape[0]
            pools.append(block)
            tags.append(np.full(block.shape[0], s_idx, dtype=np.int32))
        if not pools:  # pool_size == 0: the round is an exact no-op
            return np.zeros((0, n), dtype=np.int32), np.zeros(0, dtype=np.int32)
        return np.concatenate(pools, axis=0), np.concatenate(tags, axis=0)

    def note_pruned(self, tags: np.ndarray) -> None:
        """Record stage-1 discards (rows never reach a strategy's observe)."""
        tags = tags[tags >= 0]
        if tags.size == 0:
            return
        for s_idx, cnt in enumerate(np.bincount(tags, minlength=len(self.strategies))):
            if cnt:
                self.stats[self.strategies[s_idx].name].pruned += int(cnt)

    def observe(
        self,
        tags: np.ndarray,
        racks: np.ndarray,
        vals: np.ndarray,
        prev_best: float,
    ) -> None:
        """Feed one scored block back (sweep blocks carry tag -1: they only
        grow the elite pool; refinement rows update strategy accounting and
        are dispatched to their strategy's ``observe`` hook)."""
        self.elites.add_batch(racks, vals)
        if self._view is None or not (tags >= 0).any():
            return
        for s_idx, strat in enumerate(self.strategies):
            m = tags == s_idx
            if not m.any():
                continue
            v = vals[m]
            st = self.stats[strat.name]
            st.evaluated += int(v.size)
            st.improved += int((v < prev_best - 1e-9).sum())
            self._round_eval[s_idx] += v.size
            mn = float(v.min())
            if mn < self._round_min[s_idx]:
                self._round_min[s_idx] = mn
            strat.observe(self._view, racks[m], v)

    def end_round(self, best_rack: np.ndarray, best_val: float) -> None:
        """Close the round: strategy hooks, improvement credits, weights."""
        self._view = self._make_view(best_rack, best_val)
        for strat in self.strategies:
            strat.end_round(self._view)
        credits = np.where(
            self._round_eval > 0,
            np.maximum(0.0, self._round_start_best - self._round_min),
            0.0,
        )
        yields = credits / np.maximum(self._round_eval, 1)
        # Allocator signal: the current round's yields, plus (with
        # ``yield_decay`` > 0) a geometrically decayed memory of past
        # rounds' yields — stale evidence keeps a fading vote in how a
        # productive round's budget shift is apportioned. The update
        # itself stays gated on the *current* round producing yield
        # (``yields.max() > 0``): a stalled round must never re-apply old
        # evidence, or one early lucky round would pin the weights at the
        # clip extremes. The default 0.0 contributes exact zeros,
        # reproducing the memoryless multiplicative-weights update bit
        # for bit.
        self._yield_acc = self.yield_decay * self._yield_acc + yields
        if float(yields.max()) > 0.0 and len(self.strategies) > 1:
            signal = self._yield_acc
            self.weights *= np.exp(self.eta * signal / float(signal.max()))
            self.weights = np.clip(self.weights / self.weights.mean(), 0.05, 20.0)
        for s_idx, strat in enumerate(self.strategies):
            st = self.stats[strat.name]
            st.improvement += float(credits[s_idx])
            st.weight = float(self.weights[s_idx])
        self.round_index += 1
