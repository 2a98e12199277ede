# Copied from src/repro/online/__init__.py; imports retargeted to repro_torch.
"""Online arrival-driven scheduling service (beyond-paper).

Turns the offline mega-batch engine into a serving system for the paper's
production scenario (§V): jobs arrive over time, queue for residual
cluster capacity, and are (re-)optimized in windowed ``schedule_fleet``
mega-batches with warm-started search. Commits are channel-feasible:
every schedule is arbitrated onto the shared physical wired channel and
its exclusively granted wireless subchannels before it lands on the
cluster timeline, and the committed timeline is audited overlap-free.
Layers:

  workload  — seeded Poisson / production-mix / trace arrival generators
              + SLO-tier/tenant annotation layer (deadlines from the
              rigorous critical-path bound)
  cluster   — global cluster timeline, residual-capacity instances,
              cross-job channel arbitration + commit-order replay +
              feasibility audit
  service   — admission event loop (FIFO / backfilling / free overtaking)
              + SLO admission (fifo / edf / wfair queue ordering,
              reject-or-defer admission control, bounded starvation)
              + warm-started re-optimization + coflow-aware commit-order
              arbitration (fifo / sigma / search)
  metrics   — per-job queueing/JCT records and aggregate OnlineResult
              (per-tier SLO attainment, per-tenant queueing percentiles)
"""

from repro_torch.online.cluster import (
    ClusterTimeline,
    OrderReplay,
    ResidualView,
    replay_commit_order,
    reservation_backfill_safe,
)
from repro_torch.online.metrics import JobMetrics, OnlineResult, StreamingSeries
from repro_torch.online.service import DEFAULT_SOLVER_KWARGS, OnlineScheduler
from repro_torch.online.workload import (
    ArrivalEvent,
    DEFAULT_SLO_TIERS,
    SloTier,
    poisson_arrivals,
    production_arrivals,
    stream_poisson_arrivals,
    stream_production_arrivals,
    stream_tiered_arrivals,
    tiered_poisson_arrivals,
    tiered_production_arrivals,
    trace_arrivals,
)

__all__ = [
    "ArrivalEvent",
    "ClusterTimeline",
    "DEFAULT_SLO_TIERS",
    "SloTier",
    "DEFAULT_SOLVER_KWARGS",
    "JobMetrics",
    "OnlineResult",
    "OnlineScheduler",
    "OrderReplay",
    "ResidualView",
    "StreamingSeries",
    "replay_commit_order",
    "reservation_backfill_safe",
    "poisson_arrivals",
    "production_arrivals",
    "stream_poisson_arrivals",
    "stream_production_arrivals",
    "stream_tiered_arrivals",
    "tiered_poisson_arrivals",
    "tiered_production_arrivals",
    "trace_arrivals",
]
