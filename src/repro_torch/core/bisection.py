# Ported from src/repro/core/bisection.py; imports retargeted to repro_torch.
"""Decomposition & acceleration via bisection on feasibility subproblems (§IV-D).

RP is decomposed into feasibility subproblems FP(ℓ): "does a schedule with
C_max ≤ ℓ exist?", with ℓ bisected over [T_min, T_max]. Each iteration halves
the interval; after g iterations the optimality gap is 2^-g (T_max - T_min).
Because ℓ also serves as the big-M horizon, FP instances shrink as the upper
bound tightens — this is the paper's acceleration.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import bounds as bounds_mod
from repro_torch.core.instance import ProblemInstance
from repro_torch.core.milp import build_rp
from repro_torch.core.schedule import Schedule
from repro_torch.core.solver_milp import solve_rp

__all__ = ["BisectionResult", "solve_bisection"]


@dataclasses.dataclass
class BisectionResult:
    schedule: Schedule | None
    makespan: float
    iterations: int
    final_gap: float
    wall_s: float
    history: list[tuple[float, float, bool]]  # (lo, hi, feasible-at-mid)


def solve_bisection(
    inst: ProblemInstance,
    rel_tol: float = 1e-3,
    abs_tol: float = 1e-6,
    max_iters: int = 64,
    time_limit_per_fp: float | None = None,
    paper_exact_binding: bool = False,
) -> BisectionResult:
    """Optimal C_max via §IV-D bisection over FP feasibility subproblems."""
    t0 = time.perf_counter()
    lo = bounds_mod.lower_bound(inst)
    hi = bounds_mod.upper_bound(inst)
    best: Schedule | None = None
    history: list[tuple[float, float, bool]] = []

    # First check: is the lower bound itself attainable? (saves an iteration
    # when the critical path dominates — common at small network factors.)
    it = 0
    while hi - lo > max(abs_tol, rel_tol * max(1.0, hi)) and it < max_iters:
        mid = 0.5 * (lo + hi)
        model = build_rp(
            inst,
            tmax=mid,
            feasibility_only=True,
            paper_exact_binding=paper_exact_binding,
        )
        res = solve_rp(model, time_limit=time_limit_per_fp, verify=False)
        feasible = res.schedule is not None
        history.append((lo, hi, feasible))
        if feasible:
            assert res.schedule is not None
            # Verify against OP semantics before trusting the incumbent.
            from repro_torch.core.schedule import check_feasible

            check_feasible(inst, res.schedule, tol=1e-4)
            best = res.schedule
            hi = res.schedule.makespan  # jump below mid: actual achieved value
        else:
            lo = mid
        it += 1

    if best is None:
        # hi (= T_max) is always attainable: everything on one rack.
        from repro_torch.core.baselines import single_rack_schedule

        best = single_rack_schedule(inst)
    return BisectionResult(
        schedule=best,
        makespan=best.makespan,
        iterations=it,
        final_gap=hi - lo,
        wall_s=time.perf_counter() - t0,
        history=history,
    )
