"""Stage 1 of the port's fleet engine in one launch.

The fused kernel ``cpm_fleet_lb`` / ``cpm_fleet_lb_masked`` computes the
JAX package's whole stage-1 device program
(``repro.core.vectorized._fleet_lb_device``: adjacency and mask scatter,
contention terms, Pallas relaxation) from the candidates' racks and the
per-instance edge tables. Its plain version ``ref_fleet_lb`` is the CPU
route of the port's ``_fleet_lb_device``; here it is held against the JAX
package on a mixed fleet, and the wrapper's checks and routes are tested.
On a card the kernels are held against their plain versions.

Every comparison is exact: the bound is float32 adds, maxes and one
division in a fixed order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import vectorized as RV
from repro.core.instance import Topology as RTopology
from repro_torch.core import vectorized as TV
from repro_torch.interop import instance_from_arrays, instance_to_arrays
from repro_torch.kernels import cpm
from repro_torch.kernels import ref as tref


def _instance(seed, n_tasks, n_racks, n_wireless, topo, edgeless=False):
    rng = np.random.default_rng(seed)
    if edgeless:
        job = R.DagJob(p=rng.uniform(1, 9, n_tasks), edges=np.zeros((0, 2)), d=np.zeros(0))
    else:
        job = R.random_job(rng, None, n_tasks=n_tasks, rho=1.0)
    kw = {}
    if topo:
        kw["topology"] = RTopology(reach=rng.uniform(size=(n_racks, n_wireless)) < 0.5)
    return R.ProblemInstance(job=job, n_racks=n_racks, n_wireless=n_wireless, **kw)


def _mixed_fleet(topo: bool):
    """Different task, edge and rack counts; an edgeless job; with ``topo``
    a restricted topology on two instances of four."""
    return [
        _instance(1, 5, 3, 1, topo),
        _instance(2, 8, 4, 2, False),
        _instance(3, 3, 2, 1, False, edgeless=True),
        _instance(4, 11, 6, 2, topo),
    ]


def _candidates(rng, insts, n_pad, rows, pad):
    """``rows`` rows a instance, packed as the engine packs a stage-1
    launch: the last ``pad`` rows of each block are padding (all tasks on
    rack 0), padded tasks sit on rack 0."""
    B = len(insts) * rows
    rack = np.zeros((B, n_pad), np.int32)
    iid = np.zeros(B, np.int32)
    for i, inst in enumerate(insts):
        lo, n = i * rows, inst.job.n_tasks
        rack[lo : lo + rows - pad, :n] = rng.integers(0, inst.n_racks, (rows - pad, n))
        iid[lo : lo + rows] = i
    return rack, iid


@pytest.mark.parametrize("topo", [True, False], ids=["mixed_topology", "no_topology"])
@pytest.mark.parametrize("rounds", ["depth", "below"])
@pytest.mark.parametrize("contention", [True, False])
def test_stage1_plain_route_matches_reference(topo, rounds, contention):
    insts = _mixed_fleet(topo)
    tinsts = [instance_from_arrays(instance_to_arrays(i)) for i in insts]
    dims = RV._fleet_dims(insts, use_wireless=True)
    assert dataclasses.astuple(dims) == dataclasses.astuple(TV._fleet_dims(tinsts, use_wireless=True))
    n_iters = dims.n_iters if rounds == "depth" else 2
    rack, iid = _candidates(np.random.default_rng(7), insts, dims.n_pad, 24, 5)
    kw = dict(M_pad=dims.M_pad, n_iters=n_iters, block_b=8, contention=contention)
    want = np.asarray(
        RV._fleet_lb_device(
            jnp.asarray(rack), jnp.asarray(iid), *RV._build_lb_arrays(insts, dims), **kw
        )
    )
    before = dict(cpm.launches)
    got = TV._fleet_lb_device(
        TV._rows_to_device(rack, "cpu"), TV._rows_to_device(iid, "cpu"),
        *TV._build_lb_arrays(tinsts, dims, "cpu"), **kw,
    )
    assert cpm.launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(want).all()


def synthetic_stage1(rng, n_inst, n_pad, m_pad, M_pad, B):
    """Stage-1 tables in ``_build_lb_arrays``' layout for random DAGs of up
    to ``n_pad`` tasks (instance 0 edgeless, odd instances with a random
    ``pair_ok``), and ``B`` candidate rows of random instances."""
    f32 = np.float32
    src = np.zeros((n_inst, m_pad), np.int64)
    dst = np.zeros((n_inst, m_pad), np.int64)
    p_src = np.zeros((n_inst, m_pad), f32)
    c_local = np.full((n_inst, m_pad), -np.inf, f32)
    c_net = np.full((n_inst, m_pad), -np.inf, f32)
    net_work = np.zeros((n_inst, m_pad), f32)
    p_task = np.zeros((n_inst, n_pad), f32)
    chan_div = np.ones(n_inst, f32)
    pair_ok = np.ones((n_inst, M_pad, M_pad), f32)
    uplift = np.zeros((n_inst, m_pad), f32)
    sizes = []
    for i in range(n_inst):
        n, M = int(rng.integers(1, n_pad + 1)), int(rng.integers(1, M_pad + 1))
        pairs = [(u, v) for u in range(n) for v in range(u + 1, n)]
        m = 0 if i == 0 else min(len(pairs), int(rng.integers(0, m_pad + 1)))
        p = rng.uniform(1, 100, n).astype(f32)
        p_task[i, :n] = p
        chan_div[i] = 1 + int(rng.integers(0, 3))
        for e, k in enumerate(rng.permutation(len(pairs))[:m]):
            u, v = pairs[k]
            src[i, e], dst[i, e] = u, v
            p_src[i, e] = p[u]
            c_local[i, e] = rng.uniform(0.1, 1)
            c_net[i, e] = net_work[i, e] = rng.uniform(1, 30)
            uplift[i, e] = rng.uniform(0, 40)
        if i % 2:
            pair_ok[i, :M, :M] = rng.random((M, M)) < 0.5
        sizes.append((n, M))
    inst = rng.integers(0, n_inst, size=B)
    racks = np.zeros((B, n_pad), np.int64)
    for b, i in enumerate(inst):
        n, M = sizes[i]
        racks[b, :n] = rng.integers(0, M, n)
    t = torch.from_numpy
    tables = tuple(t(a) for a in (src, dst, p_src, c_local, c_net, net_work, p_task, chan_div))
    return t(racks), t(inst.astype(np.int64)), tables, t(pair_ok), t(uplift)


@pytest.mark.parametrize("n_pad,M_pad,m_pad", [(5, 2, 8), (16, 8, 32), (33, 16, 16)])
def test_fleet_wrapper_cpu_route_is_plain_version(n_pad, M_pad, m_pad):
    rng = np.random.default_rng(n_pad)
    racks, inst, tables, pair_ok, uplift = synthetic_stage1(rng, 4, n_pad, m_pad, M_pad, 37)
    before = dict(cpm.launches)
    for topo in ((), (pair_ok, uplift)):
        kw = dict(M_pad=M_pad, n_iters=None, contention=True)
        got = cpm.fleet_combined_lb(racks, inst, *tables, *topo, **kw)
        want = tref.ref_fleet_lb(racks, inst, *tables, *topo, **dict(kw, n_iters=n_pad - 1))
        assert got.dtype == torch.float32 and got.shape == (37,)
        assert torch.equal(got, want)
        assert torch.equal(cpm.fleet_combined_lb(racks.int(), inst.int(), *tables, *topo, **kw), got)
    assert cpm.launches == before


def test_fleet_mask_and_contention_only_raise_the_bound():
    rng = np.random.default_rng(3)
    racks, inst, tables, pair_ok, uplift = synthetic_stage1(rng, 6, 16, 32, 8, 64)
    kw = dict(M_pad=8, n_iters=15)
    plain = cpm.fleet_combined_lb(racks, inst, *tables, contention=False, **kw)
    cont = cpm.fleet_combined_lb(racks, inst, *tables, contention=True, **kw)
    masked = cpm.fleet_combined_lb(racks, inst, *tables, pair_ok, uplift, contention=False, **kw)
    assert (cont >= plain).all() and (cont > plain).any()
    assert (masked >= plain).all() and (masked > plain).any()
    # Every bound is at least the row's longest task.
    assert (plain >= tables[6][inst].amax(dim=1)).all()


@pytest.mark.parametrize(
    "bad",
    ["racks_dtype", "inst_dtype", "src_dtype", "table_dtype", "racks_shape",
     "inst_shape", "p_task_shape", "pair_ok_alone", "pair_ok_shape", "device",
     "noncontig", "n_too_big"],
)
def test_fleet_wrapper_rejects_bad_inputs(bad):
    rng = np.random.default_rng(0)
    racks, inst, tables, pair_ok, uplift = synthetic_stage1(rng, 3, 8, 8, 4, 10)
    tables = list(tables)
    topo = [pair_ok, uplift]
    err = ValueError
    if bad == "racks_dtype":
        racks, err = racks.float(), TypeError
    elif bad == "inst_dtype":
        inst, err = inst.int(), TypeError
    elif bad == "src_dtype":
        tables[0], err = tables[0].int(), TypeError
    elif bad == "table_dtype":
        tables[2], err = tables[2].double(), TypeError
    elif bad == "racks_shape":
        racks = racks.reshape(-1)
    elif bad == "inst_shape":
        inst = torch.zeros(11, dtype=torch.int64)
    elif bad == "p_task_shape":
        tables[6] = torch.zeros((3, 9))
    elif bad == "pair_ok_alone":
        topo = [pair_ok, None]
    elif bad == "pair_ok_shape":
        topo = [pair_ok[:, :3], uplift]
    elif bad == "device":
        tables[4] = torch.empty(tables[4].shape, device="meta")
    elif bad == "noncontig":
        racks = torch.zeros((10, 16), dtype=torch.int64)[:, ::2]
    elif bad == "n_too_big":
        racks = torch.zeros((10, cpm.MAX_N + 1), dtype=torch.int64)
    with pytest.raises(err):
        cpm.fleet_combined_lb(racks, inst, *tables, *topo, M_pad=4, n_iters=None,
                              contention=True)


@pytest.mark.cuda
def test_cuda_fleet_kernel_equals_plain_version_on_card():
    """On a card: the fused kernel equals ``ref_fleet_lb`` bit for bit over
    n_pad (lane groups of 2, 4 and 16 lanes, padded and full, and the
    shared-tile body above 32), rack buckets, round counts, both bodies and
    contention on and off; B = 203 is no multiple of any block's rows. The
    kernel takes int32 rows only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU route is covered above)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    B = 203
    for n_pad in (1, 5, 8, 16, 17, 32, 33, 64, 128):
        for M_pad in (2, 8, 16):
            m_pad = max(8, min(4 * n_pad, 256))
            racks, inst, tables, pair_ok, uplift = (
                x.to(dev) if isinstance(x, torch.Tensor) else tuple(t.to(dev) for t in x)
                for x in synthetic_stage1(rng, 5, n_pad, m_pad, M_pad, B)
            )
            for n_iters in sorted({0, 1, n_pad - 1}):
                for topo in ((), (pair_ok, uplift)):
                    for contention in (True, False):
                        kw = dict(M_pad=M_pad, n_iters=n_iters, contention=contention)
                        key = "fleet_lb_masked" if topo else "fleet_lb"
                        before = cpm.launches[key]
                        want = tref.ref_fleet_lb(racks, inst, *tables, *topo, **kw)
                        got = cpm.fleet_combined_lb(racks.int(), inst.int(), *tables, *topo, **kw)
                        assert torch.equal(got, want), (n_pad, M_pad, n_iters, topo != (),
                                                        contention)
                        assert cpm.launches[key] == before + 1
                        with pytest.raises(TypeError):
                            cpm.fleet_combined_lb(racks, inst, *tables, *topo, **kw)
    torch.cuda.synchronize()
