"""Port search engine against the JAX package: the stage-1 bound (kernel
path and edge-list path), the stage-2 evaluator, ``vectorized_search`` and
``schedule_fleet`` results and counters, fleet-equals-solo, argmin ties,
and the port's own size-bucket (trace) counters.

All comparisons are exact: every device operation is an add, a max, a
compare, an argmin or one division in a fixed order, so the port on the
CPU equals the JAX package bit for bit.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro.core import vectorized as RV
from repro.core.instance import Topology as RTopology
from repro_torch.core import check_feasible
from repro_torch.core import vectorized as TV
from repro_torch.core.dag import DagJob
from repro_torch.core.instance import ProblemInstance, Topology
from repro_torch.interop import instance_from_arrays, instance_to_arrays

CPU = "cpu"


def _port(inst):
    return instance_from_arrays(instance_to_arrays(inst))


def make_instance(seed, n_tasks=5, n_racks=3, n_wireless=1, topo=False, family=None):
    rng = np.random.default_rng(seed)
    job = R.random_job(rng, family, n_tasks=n_tasks, rho=1.0)
    kw = {}
    if topo:
        reach = rng.uniform(size=(n_racks, n_wireless)) < 0.5
        kw["topology"] = RTopology(reach=reach)
    return R.ProblemInstance(job=job, n_racks=n_racks, n_wireless=n_wireless, **kw)


def _stats(stats):
    return {k: dataclasses.asdict(v) for k, v in stats.items()}


def _assert_same_result(a, b):
    assert a.makespan == b.makespan
    np.testing.assert_array_equal(a.best_assignment, b.best_assignment)
    assert a.n_candidates == b.n_candidates
    assert a.n_pruned == b.n_pruned
    assert a.n_evaluated == b.n_evaluated
    assert a.refine_rounds == b.refine_rounds
    assert _stats(a.strategy_stats) == _stats(b.strategy_stats)


@pytest.mark.parametrize("topo", [False, True])
@pytest.mark.parametrize("contention", [True, False])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_batched_lower_bound_matches_reference(use_kernel, contention, topo):
    for seed in range(3):
        ri = make_instance(seed, n_tasks=6, n_racks=4, n_wireless=2, topo=topo)
        cands = RV.enumerate_assignments(ri.job.n_tasks, ri.n_racks)
        want = RV.batched_lower_bound(
            ri, cands, use_kernel=use_kernel, contention=contention
        )
        got = TV.batched_lower_bound(
            _port(ri), cands, use_kernel=use_kernel, contention=contention, device=CPU
        )
        np.testing.assert_array_equal(got, want)


def test_batched_lower_bound_edgeless_job():
    job = R.DagJob(p=np.array([3.0, 5.0, 2.0]), edges=np.zeros((0, 2)), d=np.zeros(0))
    ri = R.ProblemInstance(job=job, n_racks=2, n_wireless=1)
    cands = RV.enumerate_assignments(3, 2)
    for use_kernel in (True, False):
        np.testing.assert_array_equal(
            TV.batched_lower_bound(_port(ri), cands, use_kernel=use_kernel, device=CPU),
            RV.batched_lower_bound(ri, cands, use_kernel=use_kernel),
        )


@pytest.mark.parametrize("topo", [False, True])
def test_evaluator_matches_reference(topo):
    ri = make_instance(4, n_tasks=7, n_racks=4, n_wireless=2, topo=topo)
    cands = RV.enumerate_assignments(7, 4)[:300]
    want = np.asarray(RV.make_batched_evaluator(ri)(cands))
    got = TV.make_batched_evaluator(_port(ri), device=CPU)(cands).numpy()
    np.testing.assert_array_equal(got, want)
    want_w = np.asarray(RV.make_batched_evaluator(ri, use_wireless=False)(cands))
    got_w = TV.make_batched_evaluator(_port(ri), use_wireless=False, device=CPU)(cands)
    np.testing.assert_array_equal(got_w.numpy(), want_w)


def test_argmin_tie_takes_lowest_channel():
    """The op table walks edge 0->2 first. It ties on all three channels
    (q = q̌) and must take the wired channel, index 0, as jnp.argmin does;
    edge 0->1 is then forced to queue behind it on the wired channel (rack
    1 reaches no subchannel): makespan 1 + 10 + 10 + 1 = 22. Picking a
    wireless channel on the tie would give 12."""
    reach = np.array([[1, 1], [0, 0], [1, 1]], bool)
    job = DagJob(p=[1.0, 1.0, 1.0], edges=[[0, 1], [0, 2]], d=[10.0, 10.0])
    ti = ProblemInstance(job=job, n_racks=3, n_wireless=2, topology=Topology(reach=reach))
    rack = np.array([[0, 1, 2]])
    got = TV.make_batched_evaluator(ti, device=CPU)(rack).numpy()
    assert got.tolist() == [22.0]
    ri = R.ProblemInstance(
        job=R.DagJob(p=job.p, edges=job.edges, d=job.d),
        n_racks=3, n_wireless=2, topology=RTopology(reach=reach),
    )
    np.testing.assert_array_equal(got, np.asarray(RV.make_batched_evaluator(ri)(rack)))


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(),
        dict(batch_size=64),
        dict(batch_size=64, contention=False),
        dict(batch_size=64, use_kernel=False),
        dict(max_enumerate=1000, n_samples=512, batch_size=256),
        dict(max_enumerate=1000, n_samples=512, batch_size=256, strategies="portfolio"),
    ],
    ids=["default", "bs64", "no_contention", "edge_list", "sampled", "portfolio"],
)
def test_vectorized_search_matches_reference(kwargs):
    sampled = "n_samples" in kwargs
    ri = make_instance(3, n_tasks=11 if sampled else 7, n_racks=6 if sampled else 4)
    want = RV.vectorized_search(ri, **kwargs)
    got = TV.vectorized_search(_port(ri), device=CPU, **kwargs)
    _assert_same_result(got, want)
    check_feasible(_port(ri), got.schedule)


def _mixed_fleet():
    """Ragged, mixed-topology fleet: different task / edge / rack /
    subchannel counts, half of it under a restricted topology, one
    instance in the sampled regime."""
    insts = [
        make_instance(
            s, n_tasks=5 + s % 4, n_racks=3 + s % 3, n_wireless=1 + s % 2,
            topo=(s % 2 == 1),
        )
        for s in range(5)
    ]
    insts.append(make_instance(9, n_tasks=10, n_racks=5, n_wireless=2, topo=True))
    return insts


def test_mixed_topology_fleet_matches_reference_and_solo():
    kw = dict(batch_size=64, max_enumerate=2000, n_samples=256, refine_rounds=2,
              refine_pool=128, seed=[11, 12, 13, 14, 15, 16])
    insts = _mixed_fleet()
    want = RV.schedule_fleet(insts, **kw)
    tinsts = [_port(i) for i in insts]
    got = TV.schedule_fleet(tinsts, device=CPU, **kw)
    for a, b in zip(got.results, want.results):
        _assert_same_result(a, b)
    for f in ("n_candidates", "n_pruned", "n_evaluated",
              "n_stage1_launches", "n_stage2_launches"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.makespans, want.makespans)
    assert _stats(got.strategy_stats) == _stats(want.strategy_stats)
    assert got.n_pruned > 0
    # Fleet equals solo, inside the port.
    solo_kw = {k: v for k, v in kw.items() if k != "seed"}
    for i, inst in enumerate(tinsts):
        solo = TV.vectorized_search(inst, seed=kw["seed"][i], device=CPU, **solo_kw)
        _assert_same_result(got.results[i], solo)
        check_feasible(inst, got.results[i].schedule)


def test_fleet_trace_counters_one_per_new_bucket():
    """The port's counterpart of the one-trace-per-stage contract: a fleet
    in a size bucket no earlier fleet used counts exactly one new bucket
    per stage, and a second fleet in the same bucket counts none."""
    def fleet(base):
        # Same shape profile in both fleets, so both land in one bucket.
        return [
            _port(R.ProblemInstance(
                job=R.make_onestage_mapreduce(
                    np.random.default_rng(base + s), n_map=4, n_reduce=3, rho=2.0
                ),
                n_racks=4, n_wireless=1,
            ))
            for s in range(8)
        ]

    # batch_size 72 keeps this bucket (rows = 8 * 72) private to this test.
    first = TV.schedule_fleet(fleet(0), batch_size=72, device=CPU)
    assert first.n_pruned > 0
    assert first.n_stage1_launches > 1 and first.n_stage2_launches > 1
    assert first.n_stage1_traces == 1 and first.n_stage2_traces == 1
    second = TV.schedule_fleet(fleet(100), batch_size=72, device=CPU)
    assert second.n_stage1_traces == 0 and second.n_stage2_traces == 0


def test_same_bucket_evaluators_share_a_bucket():
    insts = [
        _port(R.ProblemInstance(
            job=R.make_onestage_mapreduce(np.random.default_rng(s), n_map=3,
                                          n_reduce=3, rho=1.0),
            n_racks=3, n_wireless=1,
        ))
        for s in (10, 11)
    ]
    cands = TV.enumerate_assignments(6, 3)
    v0 = TV.make_batched_evaluator(insts[0], device=CPU)(cands).numpy()
    before = TV.TRACE_COUNT
    out = TV.make_batched_evaluator(insts[1], device=CPU)(cands).numpy()
    assert TV.TRACE_COUNT == before
    assert out.shape == (cands.shape[0],) and (out > 0).all()
    assert not np.array_equal(v0, out)


def test_fleet_validation():
    insts = [_port(make_instance(s)) for s in range(2)]
    with pytest.raises(ValueError):
        TV.schedule_fleet([], device=CPU)
    with pytest.raises(ValueError):
        TV.schedule_fleet(insts, seed=[1, 2, 3], device=CPU)
