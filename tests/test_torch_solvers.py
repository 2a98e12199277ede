"""The port's exact solvers (RP model, HiGHS, bisection, combinatorial
B&B) against the JAX package, and the reference's solver contracts on
the port alone.

Same inputs: every instance is drawn once with numpy from a fixed seed by
the reference's ``random_job`` and carried into the port through
``repro_torch.interop``. Where the reference is exact the comparison is
exact (tolerance 0): the RP model's arrays, HiGHS's status and optimum,
the bisection's C_max, iteration count and bracket history, and B&B's
makespan, schedule arrays and node counts (on instances that prove
optimal far inside their time limit, so no deadline cuts the search).

The mirrored contracts (tests/test_milp_optimal.py:38-104,
tests/test_bisection.py:88-178, tests/test_bounds_properties.py's
``assignment_bound`` hook, tests/test_integration.py:76-99 and
tests/test_vectorized.py:36-45, :70-83) run the port alone, with the
engine on ``device="cpu"``, and keep each reference test's tolerance,
stated beside its assert.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro.core import bisection as rbis
from repro.core import bnb as rbnb
from repro.core import milp as rmilp
from repro.core import solver_milp as rsolver
import repro_torch.core as T
from repro_torch.core import bisection as tbis
from repro_torch.core import bnb as tbnb
from repro_torch.core import milp as tmilp
from repro_torch.core import solver_milp as tsolver
from repro_torch.core.vectorized import (
    batched_lower_bound,
    enumerate_assignments,
    make_batched_evaluator,
    vectorized_search,
)
from repro_torch.interop import instance_from_arrays, instance_to_arrays

from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

CPU = "cpu"
EPS_SLACK = 0.15  # tests/test_milp_optimal.py: the paper's ε=0.1 slack
FP_SLACK = 1e-3   # tests/test_bisection.py: FP solver's numeric slack
SCHED_FIELDS = ("rack", "start", "chan", "tstart")


def _draw(pkg, seed, n_tasks=5, n_racks=3, n_wireless=None, rho=None):
    """tests/test_milp_optimal.py's ``make_instance`` with ``pkg``'s
    ``random_job`` (the same draws in both packages)."""
    rng = np.random.default_rng(seed)
    if n_wireless is None:
        n_wireless = int(rng.integers(0, 3))
    if rho is None:
        rho = float(rng.uniform(0.2, 2.0))
    job = pkg.random_job(rng, None, n_tasks=n_tasks, rho=rho)
    return pkg.ProblemInstance(job=job, n_racks=n_racks, n_wireless=n_wireless)


def make_instance(seed, **kw):
    """A port instance, drawn as the reference tests draw theirs."""
    return _draw(T, seed, **kw)


def _pair(seed, **kw):
    """(reference instance, port instance) from one seeded draw."""
    ri = _draw(R, seed, **kw)
    return ri, instance_from_arrays(instance_to_arrays(ri))


def _scenario_pair(j, wired=False):
    """Job j of examples/schedule_cluster.py's production scenario."""
    ri = R.ProblemInstance(
        job=R.random_job(np.random.default_rng(100 + j), None, rho=0.5),
        n_racks=8, n_wireless=2,
    )
    ti = instance_from_arrays(instance_to_arrays(ri))
    return (R.wired_only(ri), T.wired_only(ti)) if wired else (ri, ti)


def _assert_same_schedule(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for f in SCHED_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.makespan == b.makespan


# ---------------------------------------------------------------------------
# Parity with the JAX package (tolerance 0)
# ---------------------------------------------------------------------------

RP_CASES = [
    (0, dict(n_tasks=4, n_racks=2, n_wireless=1), {}),
    (1, dict(n_tasks=5, n_racks=3), {}),
    (2, dict(n_tasks=5, n_racks=3, n_wireless=2), dict(paper_exact_binding=True)),
    (3, dict(n_tasks=4, n_racks=3, n_wireless=0), {}),
    (4, dict(n_tasks=6, n_racks=3, n_wireless=2), dict(feasibility_only=True)),
    (5, dict(n_tasks=5, n_racks=4, n_wireless=1), dict(tmin=10.0)),
]


@pytest.mark.parametrize("seed,draw,kw", RP_CASES)
def test_build_rp_gives_the_same_model(seed, draw, kw):
    ri, ti = _pair(seed, **draw)
    if kw.get("feasibility_only"):
        kw = dict(kw, tmax=1.2 * R.lower_bound(ri))
    a, b = rmilp.build_rp(ri, **kw), tmilp.build_rp(ti, **kw)
    assert dataclasses.astuple(a.vm) == dataclasses.astuple(b.vm)
    assert a.vm.n_vars == b.vm.n_vars
    for name in ("c", "b_ub", "b_eq", "lb", "ub", "integrality"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    for name in ("A_ub", "A_eq"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.shape == y.shape, name
        for part in ("data", "indices", "indptr"):
            assert np.array_equal(getattr(x, part), getattr(y, part)), (name, part)
    assert (a.tmax, a.tmin) == (b.tmax, b.tmin)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("paper_exact_binding", [False, True])
def test_solve_optimal_equal(seed, paper_exact_binding):
    ri, ti = _pair(seed, n_tasks=4)
    a = rsolver.solve_optimal(ri, time_limit=60, paper_exact_binding=paper_exact_binding)
    b = tsolver.solve_optimal(ti, time_limit=60, paper_exact_binding=paper_exact_binding)
    assert a.status == b.status == 0
    assert a.makespan == b.makespan
    assert (a.n_vars, a.n_constraints) == (b.n_vars, b.n_constraints)
    _assert_same_schedule(a.schedule, b.schedule)


def test_solve_rp_equal_on_feasibility_models():
    """A feasible and an infeasible FP (below T_min) through solve_rp."""
    ri, ti = _pair(1, n_tasks=4)
    lo = R.lower_bound(ri)
    for tmax, status in ((R.upper_bound(ri), 0), (0.5 * lo, 2)):
        a = rsolver.solve_rp(rmilp.build_rp(ri, tmax=tmax, feasibility_only=True),
                             time_limit=60, verify=False)
        b = tsolver.solve_rp(tmilp.build_rp(ti, tmax=tmax, feasibility_only=True),
                             time_limit=60, verify=False)
        assert a.status == b.status == status
        assert a.makespan == b.makespan
        _assert_same_schedule(a.schedule, b.schedule)


@pytest.mark.parametrize("seed,n_tasks,rel_tol", [(0, 4, 1e-3), (2, 4, 1e-3), (11, 5, 1e-2)])
def test_solve_bisection_equal(seed, n_tasks, rel_tol):
    ri, ti = _pair(seed, n_tasks=n_tasks)
    a = rbis.solve_bisection(ri, rel_tol=rel_tol, time_limit_per_fp=60)
    b = tbis.solve_bisection(ti, rel_tol=rel_tol, time_limit_per_fp=60)
    assert a.makespan == b.makespan
    assert a.iterations == b.iterations
    assert a.history == b.history
    assert a.final_gap == b.final_gap
    _assert_same_schedule(a.schedule, b.schedule)


def _assert_same_bnb(a, b):
    assert a.proved_optimal and b.proved_optimal
    assert a.makespan == b.makespan
    assert (a.nodes_assignment, a.nodes_sequencing) == (b.nodes_assignment, b.nodes_sequencing)
    _assert_same_schedule(a.schedule, b.schedule)


BNB_CASES = (
    [("random", s, False) for s in range(4)]
    + [("random", s, True) for s in range(2)]
    # the production scenario's jobs that prove in well under a second
    + [("scenario", j, w) for j in (2, 3, 4) for w in (False, True)]
    + [("scenario", 7, False)]
)


@pytest.mark.parametrize("kind,seed,wired", BNB_CASES)
def test_solve_bnb_equal(kind, seed, wired):
    if kind == "random":
        ri, ti = _pair(seed, n_tasks=5, n_wireless=1, rho=1.0)
        if wired:
            ri, ti = R.wired_only(ri), T.wired_only(ti)
    else:
        ri, ti = _scenario_pair(seed, wired)
    _assert_same_bnb(rbnb.solve_bnb(ri, time_limit=60), tbnb.solve_bnb(ti, time_limit=60))


def test_solve_bnb_equal_with_assignment_bound_hook():
    def hook(pkg):
        def bound(inst, rack):
            rack = np.asarray(rack)
            if (rack < 0).any():
                return 0.0
            return float(pkg.contention_lower_bounds(inst, rack[None, :])[0])
        return bound

    for seed in range(2):
        ri, ti = _pair(seed, n_tasks=5, n_wireless=1, rho=1.0)
        _assert_same_bnb(rbnb.solve_bnb(ri, time_limit=60, assignment_bound=hook(R)),
                         tbnb.solve_bnb(ti, time_limit=60, assignment_bound=hook(T)))


@pytest.mark.parametrize("seed", range(3))
def test_solve_fixed_assignment_equal(seed):
    ri, ti = _pair(seed, n_tasks=6, n_racks=3, n_wireless=2, rho=1.5)
    rack = np.random.default_rng(50 + seed).integers(0, 3, ri.job.n_tasks)
    a = rbnb.solve_fixed_assignment(ri, rack, time_limit=60)
    b = tbnb.solve_fixed_assignment(ti, rack, time_limit=60)
    assert a.proved_optimal and b.proved_optimal
    assert a.makespan == b.makespan
    assert a.nodes_sequencing == b.nodes_sequencing
    _assert_same_schedule(a.schedule, b.schedule)


# ---------------------------------------------------------------------------
# tests/test_milp_optimal.py:38-104 on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_three_solvers_agree(seed):
    inst = make_instance(seed)
    r_milp = T.solve_optimal(inst, time_limit=90)
    r_bnb = T.solve_bnb(inst, time_limit=60)
    r_bis = T.solve_bisection(inst, time_limit_per_fp=60, rel_tol=1e-4)
    assert r_milp.schedule is not None
    T.check_feasible(inst, r_milp.schedule, tol=1e-4)
    T.check_feasible(inst, r_bnb.schedule)
    # the reference's tolerances: EPS_SLACK, and 1e-3 relative for bisection
    assert r_bnb.makespan == pytest.approx(r_milp.makespan, abs=EPS_SLACK)
    assert r_bis.makespan == pytest.approx(
        r_milp.makespan, abs=max(EPS_SLACK, 1e-3 * r_milp.makespan + 1e-4)
    )


@pytest.mark.parametrize("seed", range(3))
def test_paper_exact_binding_equivalent(seed):
    inst = make_instance(seed, n_tasks=4)
    a = T.solve_optimal(inst, time_limit=60, paper_exact_binding=False)
    b = T.solve_optimal(inst, time_limit=60, paper_exact_binding=True)
    assert a.makespan == pytest.approx(b.makespan, abs=EPS_SLACK)


def test_optimal_within_paper_bounds():
    for seed in range(5):
        inst = make_instance(seed + 50, n_tasks=5)
        r = T.solve_bnb(inst, time_limit=30)
        assert T.lower_bound(inst) - 1e-6 <= r.makespan <= T.upper_bound(inst) + 1e-6


def test_wireless_augmentation_never_worse():
    for seed in range(4):
        job = T.random_job(np.random.default_rng(seed), None, n_tasks=5, rho=1.0)
        prev = None
        for k in (0, 1, 2):
            inst = T.ProblemInstance(job=job, n_racks=3, n_wireless=k)
            mk = T.solve_bnb(inst, time_limit=30).makespan
            if prev is not None:
                assert mk <= prev + EPS_SLACK
            prev = mk


def test_rp_model_dimensions():
    inst = make_instance(0, n_tasks=4, n_racks=2, n_wireless=1)
    model = T.build_rp(inst)
    vm = model.vm
    n, M, m, C = vm.n, vm.M, vm.m, vm.C
    assert C == 3  # wired + local + 1 wireless
    expected = (
        2 * n * M + 2 * m * C + vm.n_pairs_v * M + n * (n - 1)
        + vm.n_pairs_e * (C - 1) + m * (m - 1) + 1
    )
    assert vm.n_vars == expected
    assert T.solve_rp(model, time_limit=60).schedule is not None


def test_infeasible_fp_detected():
    inst = make_instance(1, n_tasks=4)
    model = T.build_rp(inst, tmax=T.lower_bound(inst) * 0.5, feasibility_only=True)
    assert T.solve_rp(model, time_limit=60, verify=False).schedule is None


# ---------------------------------------------------------------------------
# tests/test_bisection.py:88-178 on the port
# ---------------------------------------------------------------------------


def _assert_valid_trajectory(inst, res):
    lo0, hi0 = T.lower_bound(inst), T.upper_bound(inst)
    if res.history:
        assert res.history[0][0] == pytest.approx(lo0)
        assert res.history[0][1] == pytest.approx(hi0)
    for i, (lo, hi, feasible) in enumerate(res.history):
        assert lo < hi
        mid = 0.5 * (lo + hi)
        if i + 1 < len(res.history):
            nlo, nhi, _ = res.history[i + 1]
            if feasible:
                assert nlo == pytest.approx(lo)
                assert nhi <= mid + FP_SLACK
            else:
                assert nlo == pytest.approx(mid)
                assert nhi == pytest.approx(hi)
            assert nlo >= lo - 1e-12 and nhi <= hi + 1e-12
    assert res.iterations == len(res.history)
    final_lo = lo0
    for lo, hi, feasible in res.history:
        if not feasible:
            final_lo = 0.5 * (lo + hi)
    assert res.makespan >= final_lo - FP_SLACK


@pytest.mark.parametrize("seed", range(4))
def test_bracket_invariant(seed):
    inst = make_instance(seed)
    res = T.solve_bisection(inst, rel_tol=1e-3, time_limit_per_fp=60)
    assert res.schedule is not None
    T.check_feasible(inst, res.schedule, tol=1e-4)
    assert res.makespan == pytest.approx(res.schedule.makespan)
    _assert_valid_trajectory(inst, res)


def test_convergence_tolerance_respected():
    inst = make_instance(11)
    rel_tol = 1e-2
    res = T.solve_bisection(inst, rel_tol=rel_tol, max_iters=64, time_limit_per_fp=60)
    assert res.final_gap <= max(1e-6, rel_tol * max(1.0, res.makespan)) + 1e-12
    assert res.iterations < 64
    assert res.wall_s >= 0.0


def test_tighter_tolerance_never_loosens_gap():
    inst = make_instance(12)
    loose = T.solve_bisection(inst, rel_tol=3e-2, time_limit_per_fp=60)
    tight = T.solve_bisection(inst, rel_tol=1e-3, time_limit_per_fp=60)
    assert tight.final_gap <= loose.final_gap + 1e-12
    assert tight.iterations >= loose.iterations
    assert tight.makespan <= loose.makespan + FP_SLACK


def test_max_iters_zero_falls_back_to_single_rack():
    inst = make_instance(13)
    res = T.solve_bisection(inst, max_iters=0)
    assert res.iterations == 0 and res.history == []
    assert res.schedule is not None
    T.check_feasible(inst, res.schedule)
    assert res.makespan <= T.upper_bound(inst) + FP_SLACK


@settings(max_examples=6, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    seed=st.integers(0, 10**6),
    n_tasks=st.integers(3, 5),
    n_racks=st.integers(2, 3),
    n_wireless=st.integers(0, 2),
    rho=st.floats(0.25, 2.0, allow_nan=False),
)
def test_bisection_matches_bnb_property(seed, n_tasks, n_racks, n_wireless, rho):
    inst = make_instance(seed, n_tasks=n_tasks, n_racks=n_racks,
                         n_wireless=n_wireless, rho=rho)
    res = T.solve_bisection(inst, rel_tol=1e-3, time_limit_per_fp=60)
    assert res.schedule is not None
    T.check_feasible(inst, res.schedule, tol=1e-4)
    _assert_valid_trajectory(inst, res)
    opt = T.solve_bnb(inst, time_limit=60)
    assert opt.proved_optimal
    # the reference's tolerance (tests/test_bisection.py:_check_agreement)
    tol = max(1e-3 * max(1.0, opt.makespan) + FP_SLACK, res.final_gap + FP_SLACK)
    assert res.makespan == pytest.approx(opt.makespan, abs=tol)


# ---------------------------------------------------------------------------
# The assignment_bound hook, the paper pipeline, the engine against B&B
# ---------------------------------------------------------------------------


def test_bnb_assignment_bound_hook_preserves_optimum():
    def hook(inst, rack):
        rack = np.asarray(rack)
        if (rack < 0).any():
            return 0.0
        return float(T.contention_lower_bounds(inst, rack[None, :])[0])

    for seed in range(3):
        job = T.random_job(np.random.default_rng(seed), None, n_tasks=5, rho=1.0)
        inst = T.ProblemInstance(job=job, n_racks=3, n_wireless=1)
        base = T.solve_bnb(inst, time_limit=30)
        hooked = T.solve_bnb(inst, time_limit=30, assignment_bound=hook)
        assert hooked.makespan == pytest.approx(base.makespan, abs=1e-9)
        assert hooked.proved_optimal


def test_paper_pipeline_end_to_end():
    """Wired-only >= augmented optimum, G-List wired-only >= its optimum."""
    gains = []
    for seed in range(5):
        job = T.random_job(np.random.default_rng(seed), None, n_tasks=6, rho=0.5)
        inst_w = T.ProblemInstance(job=job, n_racks=6, n_wireless=1)
        inst_0 = T.wired_only(inst_w)
        opt_w = T.solve_bnb(inst_w, time_limit=20)
        opt_0 = T.solve_bnb(inst_0, time_limit=20)
        T.check_feasible(inst_w, opt_w.schedule)
        T.check_feasible(inst_0, opt_0.schedule)
        assert opt_w.makespan <= opt_0.makespan + 0.15
        assert opt_0.makespan <= T.g_list_schedule(inst_0).makespan + 1e-6
        gains.append((opt_0.makespan - opt_w.makespan) / opt_0.makespan)
    assert np.mean(gains) >= 0.0


def _vec_instance(seed):
    """tests/test_vectorized.py's make_instance: 5 tasks, 3 racks, 1 wireless."""
    job = T.random_job(np.random.default_rng(seed), None, n_tasks=5, rho=1.0)
    return T.ProblemInstance(job=job, n_racks=3, n_wireless=1)


@pytest.mark.parametrize("seed", range(4))
def test_vectorized_score_upper_bounds_optimum(seed):
    inst = _vec_instance(seed)
    res = vectorized_search(inst, device=CPU)
    T.check_feasible(inst, res.schedule)
    opt = T.solve_bnb(inst, time_limit=30)
    assert res.makespan >= opt.makespan - 0.15
    assert res.makespan <= opt.makespan * 1.5 + 1e-6


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_lb_opt_greedy_sandwich(seed, use_kernel):
    """min LB <= exact optimum <= engine's score; LB <= each greedy score."""
    inst = _vec_instance(seed)
    cands = enumerate_assignments(inst.job.n_tasks, inst.n_racks)
    lbs = batched_lower_bound(inst, cands, use_kernel=use_kernel, device=CPU)
    opt = T.solve_bnb(inst, time_limit=30)
    res = vectorized_search(inst, use_kernel=use_kernel, device=CPU)
    assert float(lbs.min()) <= opt.makespan + 1e-3
    assert opt.makespan <= res.makespan + 0.15
    scores = make_batched_evaluator(inst, device=CPU)(cands).numpy()
    assert (lbs <= scores + 1e-3).all()
