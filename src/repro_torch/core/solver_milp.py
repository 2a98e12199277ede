# Ported from src/repro/core/solver_milp.py; imports retargeted to repro_torch.
"""Solve RP exactly by Branch and Bound (HiGHS via scipy.optimize.milp).

The paper solves RP with Gurobi's B&B; HiGHS is the offline-available
equivalent (LP-relaxation-based branch and bound with cuts). The public entry
point returns a verified :class:`Schedule` plus solver metadata.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
from scipy.optimize import Bounds, LinearConstraint, milp

from repro_torch.core.instance import ProblemInstance
from repro_torch.core.milp import RPModel, build_rp, extract_schedule
from repro_torch.core.schedule import Schedule, check_feasible

__all__ = ["MilpResult", "solve_rp", "solve_optimal"]


@dataclasses.dataclass
class MilpResult:
    schedule: Schedule | None
    makespan: float
    status: int  # scipy milp status: 0 optimal, 1 iter/time limit, 2 infeasible
    mip_gap: float
    wall_s: float
    n_vars: int
    n_constraints: int


def solve_rp(
    model: RPModel,
    time_limit: float | None = None,
    mip_rel_gap: float = 0.0,
    verify: bool = True,
) -> MilpResult:
    t0 = time.perf_counter()
    constraints = []
    if model.A_ub.shape[0]:
        constraints.append(
            LinearConstraint(model.A_ub, -np.inf, model.b_ub)
        )
    if model.A_eq.shape[0]:
        constraints.append(LinearConstraint(model.A_eq, model.b_eq, model.b_eq))
    options: dict = {"mip_rel_gap": mip_rel_gap}
    if time_limit is not None:
        options["time_limit"] = time_limit
    res = milp(
        c=model.c,
        constraints=constraints,
        integrality=model.integrality,
        bounds=Bounds(model.lb, model.ub),
        options=options,
    )
    wall = time.perf_counter() - t0
    ncons = model.A_ub.shape[0] + model.A_eq.shape[0]
    if res.x is None:
        return MilpResult(
            schedule=None,
            makespan=float("inf"),
            status=int(res.status),
            mip_gap=float("nan"),
            wall_s=wall,
            n_vars=model.vm.n_vars,
            n_constraints=ncons,
        )
    sched = extract_schedule(model, np.asarray(res.x))
    if verify:
        check_feasible(model.inst, sched, tol=1e-4)
    gap = float(getattr(res, "mip_gap", 0.0) or 0.0)
    return MilpResult(
        schedule=sched,
        makespan=sched.makespan,
        status=int(res.status),
        mip_gap=gap,
        wall_s=wall,
        n_vars=model.vm.n_vars,
        n_constraints=ncons,
    )


def solve_optimal(
    inst: ProblemInstance,
    time_limit: float | None = None,
    mip_rel_gap: float = 0.0,
    paper_exact_binding: bool = False,
    tmax: float | None = None,
) -> MilpResult:
    """Build RP for ``inst`` and solve to optimality (the paper's method)."""
    model = build_rp(
        inst, tmax=tmax, paper_exact_binding=paper_exact_binding
    )
    return solve_rp(model, time_limit=time_limit, mip_rel_gap=mip_rel_gap)
