"""Port serving loop against the JAX package: the ``production_fleet``
golden stream (which runs the device engine end to end), a
``topology="matching"`` fleet-policy serve, and traced-equals-untraced.

Each package draws its own arrival stream from the same seed (so the
port's workload generator is checked too); every comparison is exact.
"""

import numpy as np
import pytest

import repro.online as RO
from repro.core.instance import Topology as RTopology
import repro_torch.online as TO
from repro_torch.core.instance import Topology as TTopology
from repro_torch.obs import Tracer

CPU = "cpu"

# tests/test_admission.py GOLDEN["production_fleet"]: the default service
# path through the fleet engine, hardcoded there from the JAX package.
GOLDEN_FLEET = (
    [
        (0, 6.1001481267803985, 217.14539798702484, 211.04524986024444, 5, 2),
        (1, 18.262137412159362, 271.7465923371507, 253.48445492499133, 2, 0),
        (2, 217.14539798702484, 348.5513576149018, 131.40595962787697, 4, 2),
        (3, 217.14539798702484, 691.8271308510732, 474.6817328640484, 1, 0),
        (4, 271.7465923371507, 395.1547551642818, 123.40816282713115, 3, 1),
    ],
    dict(n_epochs=6, n_served=5, n_backfilled=0, horizon=691.8271308510732),
)
FLEET_KW = dict(
    window=5.0, seed=3,
    solver_kwargs=dict(max_enumerate=64, n_samples=64, batch_size=256,
                       refine_rounds=1, refine_pool=64),
)


def _fingerprint(res):
    return [
        (m.job_id, m.admitted, m.completion, m.makespan,
         m.n_racks_granted, m.n_wireless_granted)
        for m in res.jobs
    ]


def _counters(res):
    return dict(n_epochs=res.n_epochs, n_served=res.n_served,
                n_backfilled=res.n_backfilled, horizon=res.horizon)


def _full(res):
    """Everything a served job records that the solver decides."""
    return [
        (m.job_id, m.admitted, m.completion, m.makespan, m.solver_makespan,
         m.n_racks_granted, m.n_wireless_granted, m.n_solves)
        for m in res.jobs
    ]


def _streams(**kw):
    args = dict(seed=3, rate=1 / 10, n_jobs=5, n_racks=6, n_wireless=2)
    args.update(kw)
    r = RO.production_arrivals(**args)
    t = TO.production_arrivals(**args)
    assert [(e.time, e.job_id, e.family) for e in r] == [
        (e.time, e.job_id, e.family) for e in t
    ]
    for a, b in zip(r, t):
        np.testing.assert_array_equal(a.inst.job.p, b.inst.job.p)
        np.testing.assert_array_equal(a.inst.job.edges, b.inst.job.edges)
        np.testing.assert_array_equal(a.inst.job.d, b.inst.job.d)
    return r, t


def test_production_fleet_golden_through_port():
    r_evs, t_evs = _streams()
    got = TO.OnlineScheduler(6, 2, device=CPU, **FLEET_KW).serve(t_evs)
    rows, ctr = GOLDEN_FLEET
    assert _fingerprint(got) == rows
    assert _counters(got) == ctr
    want = RO.OnlineScheduler(6, 2, **FLEET_KW).serve(r_evs)
    assert _full(got) == _full(want)
    assert got.n_solves == want.n_solves
    assert got.n_candidates == want.n_candidates
    assert got.n_pruned == want.n_pruned


def test_matching_topology_fleet_serve_matches_reference():
    r_evs, t_evs = _streams(n_jobs=6, n_racks=4)
    reach = np.ones((4, 2), bool)
    kw = dict(FLEET_KW, topology="matching")
    want = RO.OnlineScheduler(
        4, 2, cluster_topology=RTopology(reach=reach, degree=1, delta=0.5), **kw
    ).serve(r_evs)
    got = TO.OnlineScheduler(
        4, 2, cluster_topology=TTopology(reach=reach, degree=1, delta=0.5),
        device=CPU, **kw,
    ).serve(t_evs)
    assert _full(got) == _full(want)
    assert _counters(got) == _counters(want)
    assert got.n_reconfigs == want.n_reconfigs
    assert got.n_pruned == want.n_pruned


def test_traced_serve_equals_untraced():
    _, t_evs = _streams()
    base = TO.OnlineScheduler(6, 2, device=CPU, **FLEET_KW).serve(t_evs)
    tr = Tracer()
    traced = TO.OnlineScheduler(6, 2, device=CPU, tracer=tr, **FLEET_KW).serve(t_evs)
    assert _full(traced) == _full(base)
    assert _counters(traced) == _counters(base)
    assert len(tr.spans_named("epoch")) == base.n_epochs
    assert tr.counters["stage2_launches"] > 0
    assert len(tr.spans_named("stage1_launch")) == tr.counters["stage1_launches"]


def test_scheduler_rejects_unknown_device():
    with pytest.raises(ValueError):
        TO.OnlineScheduler(2, 1, device="meta")
