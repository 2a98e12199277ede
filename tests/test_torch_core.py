"""Port host model layer against the JAX package: op tables, the host
simulator, the §IV-A bounds, and the instance interop round trip.

Both packages' instances are built from the same seeded NumPy draws (the
port's through ``repro_torch.interop``), and every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro.core import bounds as rbounds
from repro.core import simulator as rsim
from repro.core.instance import Topology as RTopology
from repro.online import production_arrivals as r_production_arrivals
import repro_torch.core as T
from repro_torch.core import bounds as tbounds
from repro_torch.core import simulator as tsim
from repro_torch.interop import instance_from_arrays, instance_to_arrays

SEEDS = (0, 1, 2)


def _pair(family, seed, topo):
    """(JAX-package instance, port instance) from one seeded draw."""
    rng = np.random.default_rng(1000 * seed + 7)
    job = R.random_job(rng, family, rho=1.0)
    n_racks, n_wireless = 4, 2
    kw = {}
    if topo:
        reach = rng.uniform(size=(n_racks, n_wireless)) < 0.5
        kw["topology"] = RTopology(reach=reach, degree=1, delta=0.5)
    inst = R.ProblemInstance(
        job=job, n_racks=n_racks, n_wireless=n_wireless,
        local_delay=float(rng.uniform(0, 0.5)), **kw,
    )
    return inst, instance_from_arrays(instance_to_arrays(inst))


def _assignments(inst, count=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, inst.n_racks, size=(count, inst.job.n_tasks))


CASES = [
    (family, seed, topo)
    for family in R.JOB_FAMILIES
    for seed in SEEDS
    for topo in (False, True)
]


@pytest.mark.parametrize("family,seed,topo", CASES)
def test_op_tables_simulate_and_bounds_match(family, seed, topo):
    ri, ti = _pair(family, seed, topo)
    a, b = rsim.build_op_tables(ri), tsim.build_op_tables(ti)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    pa = rsim.pad_op_tables(ri, n_ops=64, indeg_pad=16, edge_sentinel=32)
    pb = tsim.pad_op_tables(ti, n_ops=64, indeg_pad=16, edge_sentinel=32)
    for f in dataclasses.fields(pa):
        np.testing.assert_array_equal(getattr(pa, f.name), getattr(pb, f.name))

    racks = _assignments(ri, seed=seed)
    for use_wireless in (True, False):
        for rack in racks[:4]:
            sa = rsim.simulate(ri, rack, use_wireless=use_wireless)
            sb = tsim.simulate(ti, rack, use_wireless=use_wireless)
            for f in ("rack", "start", "chan", "tstart"):
                np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
            assert sa.makespan == sb.makespan
            T.check_feasible(ti, sb)

    assert rbounds.lower_bound(ri) == tbounds.lower_bound(ti)
    assert rbounds.upper_bound(ri) == tbounds.upper_bound(ti)
    np.testing.assert_array_equal(
        rbounds.contention_lower_bounds(ri, racks),
        tbounds.contention_lower_bounds(ti, racks),
    )


def test_instance_round_trip_of_served_stream():
    """Every instance of a production stream survives the trip into the
    port and back, field for field."""
    evs = r_production_arrivals(3, rate=1 / 10, n_jobs=6, n_racks=6, n_wireless=2)
    insts = [e.inst for e in evs]
    insts.append(_pair("random_workflow", 0, True)[0])
    insts.append(
        dataclasses.replace(insts[0], local_delay=np.arange(insts[0].job.n_edges) * 0.1)
    )
    for ri in insts:
        d = instance_to_arrays(ri)
        ti = instance_from_arrays(d)
        back = instance_to_arrays(ti)
        assert d.keys() == back.keys()
        for k in d:
            np.testing.assert_array_equal(np.asarray(d[k]), np.asarray(back[k]))
        np.testing.assert_array_equal(ri.q_wired, ti.q_wired)
        np.testing.assert_array_equal(ri.r_local, ti.r_local)
        assert (ri.topology is None) == (ti.topology is None)
