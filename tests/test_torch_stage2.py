"""Stage 2 of the port's fleet engine in one launch.

The kernel ``fleet_evaluate`` (``src/repro_torch/kernels/csrc/stage2.cu``)
computes the JAX package's stage-2 device program
(``repro.core.vectorized._scan_evaluate``, a ``lax.scan`` over the padded op
tables) from the candidates' racks and the per-instance op tables. Its
plain version ``ref_fleet_evaluate`` is the CPU route of the wrapper
``repro_torch.kernels.stage2.fleet_evaluate``; here both are held against
the JAX package's compiled program on mixed fleets, and the wrapper's
checks and routes are tested. On a card the kernel is held against the
plain version.

Every comparison is exact: stage 2 is float32 adds, maxes, compares and an
argmin in a fixed order. The JAX package is imported inside the tests that
use it, so the card test runs in a process without JAX.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import DagJob, ProblemInstance, random_job
from repro_torch.core import vectorized as TV
from repro_torch.core.instance import Topology
from repro_torch.core.simulator import build_op_tables
from repro_torch.interop import instance_to_arrays
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stage2

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"


def _instance(rng, n_tasks, n_racks, n_wireless, topo, edgeless=False):
    if edgeless:
        job = DagJob(p=rng.uniform(1, 9, n_tasks), edges=np.zeros((0, 2)), d=np.zeros(0))
    else:
        job = random_job(rng, None, n_tasks=n_tasks, rho=float(rng.uniform(0.5, 2.0)))
    kw = {}
    if topo:
        kw["topology"] = Topology(reach=rng.uniform(size=(n_racks, n_wireless)) < 0.5)
    return ProblemInstance(job=job, n_racks=n_racks, n_wireless=n_wireless, **kw)


def _mixed_fleet(seed):
    """Different task, edge and so op counts; an edgeless job; a restricted
    topology on two instances; one instance with fewer wireless channels
    than the fleet (a masked +inf column)."""
    rng = np.random.default_rng(seed)
    return [
        _instance(rng, 5, 3, 2, True),
        _instance(rng, 9, 4, 2, False),
        _instance(rng, 3, 2, 2, False, edgeless=True),
        _instance(rng, 11, 6, 1, False),
        _instance(rng, 7, 5, 2, True),
    ]


def _rows(rng, insts, n_pad, layout):
    """Candidate rows. ``packed``: 64 rows an instance as the engine packs a
    stage-2 launch, the last 9 of each block padding (every task on rack 0);
    ``scattered``: B = 203 rows of random instances."""
    if layout == "packed":
        per, pad = 64, 9
        iid = np.repeat(np.arange(len(insts)), per).astype(np.int32)
    else:
        pad = 0
        iid = rng.integers(0, len(insts), 203).astype(np.int32)
    rack = np.zeros((iid.size, n_pad), np.int32)
    for b, i in enumerate(iid):
        if layout == "packed" and b % per >= per - pad:
            continue
        n = insts[i].job.n_tasks
        rack[b, :n] = rng.integers(0, insts[i].n_racks, n)
    return rack, iid


def _jax_instance(inst):
    """The same instance in the JAX package."""
    import repro.core as R
    from repro.core.instance import Topology as RTopology

    a = instance_to_arrays(inst)
    kw = {}
    if a.get("reach") is not None:
        kw["topology"] = RTopology(reach=a["reach"])
    local = a["local_delay"]
    return R.ProblemInstance(
        job=R.DagJob(p=a["p"], edges=a["edges"], d=a["d"]), n_racks=a["n_racks"],
        n_wireless=a["n_wireless"], wired_rate=a["wired_rate"],
        wireless_rate=a["wireless_rate"], local_delay=float(local) if local.ndim == 0 else local,
        **kw)


def _reference(insts, use_wireless, rack, iid):
    """The JAX package's compiled stage-2 program on its own tables (one
    device, as ``_compiled_evaluator`` builds it)."""
    import jax.numpy as jnp
    from repro.core import vectorized as RV

    rinsts = [_jax_instance(i) for i in insts]
    dims = RV._fleet_dims(rinsts, use_wireless, [RV.build_op_tables(i) for i in rinsts])
    fn = RV._compiled_evaluator(1, dims.m_pad, dims.M_pad, dims.n_chan)
    return dims, np.asarray(fn(jnp.asarray(rack), jnp.asarray(iid),
                               *RV._build_eval_stack(rinsts, dims, use_wireless)))


@pytest.mark.parametrize("layout", ["packed", "scattered"])
@pytest.mark.parametrize("use_wireless", [True, False], ids=["wireless", "wired_only"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_version_matches_reference(seed, use_wireless, layout):
    insts = _mixed_fleet(seed)
    ops = [build_op_tables(i) for i in insts]
    dims = TV._fleet_dims(insts, use_wireless, ops)
    assert dims.n_chan == (3 if use_wireless else 1)
    rack, iid = _rows(np.random.default_rng(seed + 10), insts, dims.n_pad, layout)
    rdims, want = _reference(insts, use_wireless, rack, iid)
    assert tuple(vars(rdims).values()) == tuple(vars(dims).values())
    tables = TV._build_eval_stack(insts, dims, use_wireless, "cpu", ops)
    kw = dict(m_pad=dims.m_pad, M_pad=dims.M_pad, n_chan=dims.n_chan)
    before = dict(stage2.launches)
    r64, i64 = TV._rows_to_device(rack, "cpu"), TV._rows_to_device(iid, "cpu")
    assert r64.dtype == torch.int64
    plain = tref.ref_fleet_evaluate(r64, i64, *tables, **kw)
    np.testing.assert_array_equal(plain.numpy(), want)
    for r, i in ((r64, i64), (torch.from_numpy(rack), torch.from_numpy(iid))):
        got = stage2.fleet_evaluate(r, i, *tables, **kw)
        assert got.dtype == torch.float32 and got.shape == (rack.shape[0],)
        np.testing.assert_array_equal(got.numpy(), want)
    assert stage2.launches == before
    assert np.isfinite(want).all()


def test_engine_stage2_is_the_wrapper():
    """``_scan_evaluate`` on the CPU is the wrapper's plain route, and
    ``_stage2_split`` hands it int64 rows there."""
    insts = _mixed_fleet(3)
    ops = [build_op_tables(i) for i in insts]
    dims = TV._fleet_dims(insts, True, ops)
    tables = TV._build_eval_stack(insts, dims, True, "cpu", ops)
    rack, iid = _rows(np.random.default_rng(4), insts, dims.n_pad, "scattered")
    kw = dict(m_pad=dims.m_pad, M_pad=dims.M_pad, n_chan=dims.n_chan)
    want = tref.ref_fleet_evaluate(torch.from_numpy(rack), torch.from_numpy(iid), *tables, **kw)
    dev = torch.device("cpu")
    got, = TV._stage2_split(rack, iid, [tables], [dev], dims)
    assert torch.equal(got, want)
    assert torch.equal(TV._scan_evaluate(torch.from_numpy(rack).long(),
                                         torch.from_numpy(iid).long(), *tables, **kw), want)


def test_state_limit_covers_every_bucket():
    """The wrapper's limit is the kernel's (one row a block in 227 KB of
    shared memory), and it lies above the offline bucket and a 128-task
    DAG's bucket of 4,096 edges."""
    src = (CSRC / "stage2.cu").read_text()
    smem = int(re.search(r"kSmemMax = (\d+);", src).group(1))
    assert re.search(r"kMaxWords = kSmemMax / \(int\)sizeof\(float\);", src)
    assert stage2.MAX_STATE_WORDS == smem // 4 == 58112
    assert stage2.state_words(16, 32, 8, 3) == 76
    assert stage2.state_words(128, 4096, 16, 3) == 4372 <= stage2.MAX_STATE_WORDS
    rng = np.random.default_rng(0)
    inst = ProblemInstance(job=random_job(rng, None, n_tasks=128, rho=1.0), n_racks=16,
                           n_wireless=2)
    dims = TV._fleet_dims([inst], True, [build_op_tables(inst)])
    assert (dims.n_pad, dims.m_pad) == (128, 4096)
    assert stage2.state_words(dims.n_pad, dims.m_pad, dims.M_pad, dims.n_chan) <= \
        stage2.MAX_STATE_WORDS


def _small_inputs():
    insts = _mixed_fleet(0)[:3]
    ops = [build_op_tables(i) for i in insts]
    dims = TV._fleet_dims(insts, True, ops)
    tables = list(TV._build_eval_stack(insts, dims, True, "cpu", ops))
    rack, iid = _rows(np.random.default_rng(0), insts, dims.n_pad, "scattered")
    return torch.from_numpy(rack), torch.from_numpy(iid), tables, dims


@pytest.mark.parametrize(
    "bad",
    ["rack_dtype", "inst_dtype", "index_dtype", "data_dtype", "rack_shape", "inst_shape",
     "op_in_shape", "chan_shape", "reach_shape", "device", "noncontig", "state_too_big"],
)
def test_wrapper_rejects_bad_inputs(bad):
    rack, iid, tables, dims = _small_inputs()
    kw = dict(m_pad=dims.m_pad, M_pad=dims.M_pad, n_chan=dims.n_chan)
    err, match = ValueError, None
    if bad == "rack_dtype":
        rack, err = rack.float(), TypeError
    elif bad == "inst_dtype":
        iid, err = iid.long(), TypeError
    elif bad == "index_dtype":
        tables[2], err = tables[2].int(), TypeError
    elif bad == "data_dtype":
        tables[6], err = tables[6].double(), TypeError
    elif bad == "rack_shape":
        rack = rack.reshape(-1)
    elif bad == "inst_shape":
        iid = iid[:-1]
    elif bad == "op_in_shape":
        tables[9] = tables[9][:, :-1]
    elif bad == "chan_shape":
        tables[10] = tables[10][:, :1]
    elif bad == "reach_shape":
        kw["M_pad"] = dims.M_pad * 2
    elif bad == "device":
        tables[7] = torch.empty(tables[7].shape, device="meta")
    elif bad == "noncontig":
        rack = torch.zeros((rack.shape[0], 2 * dims.n_pad), dtype=torch.int32)[:, ::2]
    elif bad == "state_too_big":
        kw["m_pad"], match = stage2.MAX_STATE_WORDS, f"m_pad {stage2.MAX_STATE_WORDS}"
    with pytest.raises(err, match=match):
        stage2.fleet_evaluate(rack, iid, *tables, **kw)


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version_on_card():
    """On a card: the kernel equals ``ref_fleet_evaluate`` bit for bit over
    size buckets (n_pad 8 to 128, so blocks of 128 rows down to 4; M_pad 2
    to 16; n_chan 1 to 3; with and without a topology, a masked wireless
    column where an instance has fewer channels), on rows packed 64 an
    instance and on B = 203 rows of random instances (no multiple of a
    block). One launch a call; int64 rows raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU route is covered above)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = 0
    for n_tasks in (3, 8, 16, 31, 64, 128):
        for n_racks in (2, 5, 16):
            for n_wireless, topo in ((0, False), (1, True), (2, False), (2, True)):
                insts = [_instance(rng, n_tasks, n_racks, n_wireless, topo),
                         _instance(rng, max(2, n_tasks // 2), max(1, n_racks - 1),
                                   max(0, n_wireless - 1), topo),
                         _instance(rng, max(2, n_tasks - 1), n_racks, n_wireless, False,
                                   edgeless=True)]
                ops = [build_op_tables(i) for i in insts]
                dims = TV._fleet_dims(insts, True, ops)
                tables = TV._build_eval_stack(insts, dims, True, dev, ops)
                kw = dict(m_pad=dims.m_pad, M_pad=dims.M_pad, n_chan=dims.n_chan)
                for layout in ("packed", "scattered"):
                    rack, iid = _rows(rng, insts, dims.n_pad, layout)
                    r32, i32 = TV._rows_to_device(rack, dev), TV._rows_to_device(iid, dev)
                    assert r32.dtype == torch.int32
                    want = tref.ref_fleet_evaluate(r32, i32, *tables, **kw)
                    before = stage2.launches["fleet_evaluate"]
                    got = stage2.fleet_evaluate(r32, i32, *tables, **kw)
                    assert torch.equal(got, want), (n_tasks, n_racks, n_wireless, topo, layout)
                    assert stage2.launches["fleet_evaluate"] == before + 1
                    with pytest.raises(TypeError):
                        stage2.fleet_evaluate(r32.long(), i32.long(), *tables, **kw)
                    cases += 1
    torch.cuda.synchronize()
    assert cases == 144
