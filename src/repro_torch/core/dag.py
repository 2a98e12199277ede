# Copied from src/repro/core/dag.py; imports retargeted to repro_torch.
"""DAG job model and workload generators.

A job is a directed acyclic graph G = (V, E): tasks with processing times
``p_v`` and edges carrying intermediate data of size ``d_(u,v)`` (paper §II).
Workload generators follow the paper's §V evaluation setup, which mirrors
Giroire et al. [19]: simple MapReduce workflows, one-stage MapReduce
workflows, and random workflows, with task processing times ~ U[1, 100] and
data sizes set through the *network factor* rho = E[transfer time]/E[proc time].
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "DagJob",
    "topological_order",
    "make_simple_mapreduce",
    "make_onestage_mapreduce",
    "make_random_workflow",
    "random_job",
    "JOB_FAMILIES",
]


@dataclasses.dataclass(frozen=True)
class DagJob:
    """An immutable DAG job.

    Attributes:
      p: float64[n_tasks] task processing times.
      edges: int64[n_edges, 2] (u, v) pairs, u -> v dependency.
      d: float64[n_edges] intermediate data sizes (abstract units; transfer
         times are derived in :class:`repro_torch.core.instance.ProblemInstance`).
      name: human-readable family tag.
    """

    p: np.ndarray
    edges: np.ndarray
    d: np.ndarray
    name: str = "job"

    def __post_init__(self) -> None:
        p = np.asarray(self.p, dtype=np.float64)
        edges = np.asarray(self.edges, dtype=np.int64).reshape(-1, 2)
        d = np.asarray(self.d, dtype=np.float64).reshape(-1)
        object.__setattr__(self, "p", p)
        object.__setattr__(self, "edges", edges)
        object.__setattr__(self, "d", d)
        if edges.shape[0] != d.shape[0]:
            raise ValueError("edges and d must have the same length")
        if edges.size and (edges.min() < 0 or edges.max() >= p.shape[0]):
            raise ValueError("edge endpoint out of range")
        if edges.size:
            if np.any(edges[:, 0] == edges[:, 1]):
                raise ValueError("self-loop edge")
            key = edges[:, 0] * p.shape[0] + edges[:, 1]
            if np.unique(key).size != key.size:
                raise ValueError("duplicate edge")
        # Validate acyclicity eagerly (raises on cycles).
        topological_order(p.shape[0], edges)

    @property
    def n_tasks(self) -> int:
        return int(self.p.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    def in_edges(self, v: int) -> np.ndarray:
        """Indices into ``edges`` of edges entering v."""
        return np.nonzero(self.edges[:, 1] == v)[0]

    def out_edges(self, v: int) -> np.ndarray:
        return np.nonzero(self.edges[:, 0] == v)[0]

    def topo_order(self) -> np.ndarray:
        return topological_order(self.n_tasks, self.edges)

    def adjacency(self) -> np.ndarray:
        """bool[n, n] adjacency matrix (u -> v)."""
        a = np.zeros((self.n_tasks, self.n_tasks), dtype=bool)
        if self.n_edges:
            a[self.edges[:, 0], self.edges[:, 1]] = True
        return a


def topological_order(n: int, edges: np.ndarray) -> np.ndarray:
    """Kahn topological sort; raises ValueError on cycles."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    indeg = np.zeros(n, dtype=np.int64)
    for _, v in edges:
        indeg[v] += 1
    stack = sorted(np.nonzero(indeg == 0)[0].tolist(), reverse=True)
    order: list[int] = []
    out: dict[int, list[int]] = {}
    for u, v in edges:
        out.setdefault(int(u), []).append(int(v))
    while stack:
        u = stack.pop()
        order.append(u)
        for v in out.get(u, ()):
            indeg[v] -= 1
            if indeg[v] == 0:
                stack.append(v)
    if len(order) != n:
        raise ValueError("graph has a cycle")
    return np.asarray(order, dtype=np.int64)


def _scale_data_sizes(
    p: np.ndarray, d_raw: np.ndarray, rho: float, rate: float
) -> np.ndarray:
    """Scale raw data sizes so E[d/rate] = rho * E[p] (paper's network factor)."""
    if d_raw.size == 0:
        return d_raw
    mean_transfer = float(np.mean(d_raw)) / rate
    target = rho * float(np.mean(p))
    if mean_transfer <= 0:
        return np.full_like(d_raw, target * rate)
    return d_raw * (target / mean_transfer)


def make_simple_mapreduce(
    rng: np.random.Generator,
    n_map: int = 4,
    rho: float = 0.5,
    rate: float = 1.0,
) -> DagJob:
    """Simple MapReduce: n_map mappers -> 1 reducer (fan-in star), per [19].

    Tasks 0..n_map-1 are mappers, task n_map is the reducer.
    """
    n = n_map + 1
    p = rng.uniform(1.0, 100.0, size=n)
    edges = np.stack(
        [np.arange(n_map), np.full(n_map, n_map)], axis=1
    ).astype(np.int64)
    d = rng.uniform(0.5, 1.5, size=n_map)
    d = _scale_data_sizes(p, d, rho, rate)
    return DagJob(p=p, edges=edges, d=d, name="simple_mapreduce")


def make_onestage_mapreduce(
    rng: np.random.Generator,
    n_map: int = 3,
    n_reduce: int = 2,
    rho: float = 0.5,
    rate: float = 1.0,
) -> DagJob:
    """One-stage MapReduce: full bipartite shuffle mappers -> reducers [19]."""
    n = n_map + n_reduce
    p = rng.uniform(1.0, 100.0, size=n)
    us, vs = np.meshgrid(np.arange(n_map), np.arange(n_map, n), indexing="ij")
    edges = np.stack([us.ravel(), vs.ravel()], axis=1).astype(np.int64)
    d = rng.uniform(0.5, 1.5, size=edges.shape[0])
    d = _scale_data_sizes(p, d, rho, rate)
    return DagJob(p=p, edges=edges, d=d, name="onestage_mapreduce")


def make_random_workflow(
    rng: np.random.Generator,
    n_tasks: int = 8,
    edge_prob: float = 0.3,
    rho: float = 0.5,
    rate: float = 1.0,
) -> DagJob:
    """Random layered-free DAG: edge (u, v) for u < v with prob edge_prob [19].

    A random topological labelling guarantees acyclicity. Isolated sinks are
    allowed (they model independent final tasks).
    """
    p = rng.uniform(1.0, 100.0, size=n_tasks)
    pairs = [
        (u, v)
        for u in range(n_tasks)
        for v in range(u + 1, n_tasks)
        if rng.uniform() < edge_prob
    ]
    # Guarantee weak connectivity of interest: ensure every non-root has at
    # least a chance of an in-edge; keep pure random otherwise (matches [19]).
    if not pairs and n_tasks > 1:
        pairs = [(0, n_tasks - 1)]
    edges = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    d = rng.uniform(0.5, 1.5, size=edges.shape[0])
    d = _scale_data_sizes(p, d, rho, rate)
    return DagJob(p=p, edges=edges, d=d, name="random_workflow")


JOB_FAMILIES = ("simple_mapreduce", "onestage_mapreduce", "random_workflow")


def random_job(
    rng: np.random.Generator,
    family: str | None = None,
    n_tasks: int | None = None,
    rho: float = 0.5,
    rate: float = 1.0,
) -> DagJob:
    """Sample a job from one of the three §V families.

    ``n_tasks`` pins the total task count (paper: uniform in [5, 10]).
    """
    if family is None:
        family = JOB_FAMILIES[int(rng.integers(len(JOB_FAMILIES)))]
    if n_tasks is None:
        n_tasks = int(rng.integers(5, 11))
    if family == "simple_mapreduce":
        return make_simple_mapreduce(rng, n_map=max(1, n_tasks - 1), rho=rho, rate=rate)
    if family == "onestage_mapreduce":
        n_map = max(1, n_tasks // 2)
        return make_onestage_mapreduce(
            rng, n_map=n_map, n_reduce=max(1, n_tasks - n_map), rho=rho, rate=rate
        )
    if family == "random_workflow":
        return make_random_workflow(rng, n_tasks=n_tasks, rho=rho, rate=rate)
    raise ValueError(f"unknown family {family!r}")
