# Ported from src/repro/core/__init__.py; imports retargeted to repro_torch.
"""The paper's primary contribution: optimal joint job scheduling and
bandwidth augmentation for hybrid data-center networks (Guo et al., 2022),
ported to PyTorch.

Layers:
  dag / instance / schedule   — problem model and OP-semantics checker
  bounds                      — §IV-A heuristic bounds (Algorithm 1)
  simulator                   — discrete-event schedule executor
  milp / solver_milp          — §IV-B/C generalized transfer model + RP
                                 linearization, solved by B&B (HiGHS)
  bisection                   — §IV-D feasibility-subproblem decomposition
  bnb                         — combinatorial exact B&B
  vectorized                  — batched assignment search on the device
                                (stage-1 bound and stage-2 evaluator in
                                CUDA kernels)
  portfolio                   — refinement strategy portfolio (mutation /
                                crossover / annealing + yield allocator)
  coflow                      — coflow view of an admission epoch +
                                commit-order search
  baselines                   — §V comparison schedulers
"""

from repro_torch.core.dag import (
    DagJob,
    JOB_FAMILIES,
    make_onestage_mapreduce,
    make_random_workflow,
    make_simple_mapreduce,
    random_job,
)
from repro_torch.core.instance import CH_LOCAL, CH_WIRED, ProblemInstance, Topology
from repro_torch.core.schedule import FeasibilityError, Schedule, check_feasible
from repro_torch.core.bounds import (
    contention_lower_bounds,
    lower_bound,
    longest_branch,
    network_work_bounds,
    rack_load_bounds,
    upper_bound,
)
from repro_torch.core.simulator import simulate
from repro_torch.core.milp import build_rp, extract_schedule
from repro_torch.core.solver_milp import MilpResult, solve_optimal, solve_rp
from repro_torch.core.bisection import BisectionResult, solve_bisection
from repro_torch.core.bnb import BnbResult, solve_bnb
from repro_torch.core.vectorized import (
    FleetResult,
    VectorizedResult,
    schedule_fleet,
    vectorized_search,
)
from repro_torch.core.portfolio import (
    ARBITRATION_STRATEGIES,
    DEFAULT_PORTFOLIO,
    AnnealingStrategy,
    CrossoverStrategy,
    MutationStrategy,
    Portfolio,
    Strategy,
    StrategyStats,
    build_strategies,
    register_arbitration_strategy,
)
from repro_torch.core.coflow import (
    Coflow,
    OrderSearchResult,
    build_order_strategies,
    coflow_from_instance,
    coflow_from_schedule,
    search_commit_order,
    sigma_order,
)
from repro_torch.core.baselines import (
    BASELINES,
    ONLINE_BASELINES,
    fifo_solo_schedule,
    g_list_master_schedule,
    g_list_schedule,
    greedy_list_online_schedule,
    list_schedule,
    partition_schedule,
    random_schedule,
    single_rack_schedule,
    wired_only,
)

__all__ = [
    "DagJob", "JOB_FAMILIES", "make_onestage_mapreduce", "make_random_workflow",
    "make_simple_mapreduce", "random_job",
    "CH_LOCAL", "CH_WIRED", "ProblemInstance", "Topology",
    "FeasibilityError", "Schedule", "check_feasible",
    "lower_bound", "longest_branch", "upper_bound",
    "contention_lower_bounds", "network_work_bounds", "rack_load_bounds",
    "simulate",
    "build_rp", "extract_schedule",
    "MilpResult", "solve_optimal", "solve_rp",
    "BisectionResult", "solve_bisection",
    "BnbResult", "solve_bnb",
    "VectorizedResult", "vectorized_search",
    "FleetResult", "schedule_fleet",
    "DEFAULT_PORTFOLIO", "AnnealingStrategy", "CrossoverStrategy",
    "MutationStrategy", "Portfolio", "Strategy", "StrategyStats",
    "build_strategies",
    "ARBITRATION_STRATEGIES", "register_arbitration_strategy",
    "Coflow", "OrderSearchResult", "build_order_strategies",
    "coflow_from_instance", "coflow_from_schedule", "search_commit_order",
    "sigma_order",
    "BASELINES", "ONLINE_BASELINES", "fifo_solo_schedule",
    "g_list_master_schedule", "g_list_schedule", "greedy_list_online_schedule",
    "list_schedule", "partition_schedule", "random_schedule",
    "single_rack_schedule", "wired_only",
]
