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

The kernel reads int16 racks and the op tables packed once a fleet
(``stage2.pack_tables``); the packing is held lossless here, and the
engine's int16 staging of the rows is held against the plain version.

Every comparison is exact: stage 2 is float32 adds, maxes, compares and an
argmin in a fixed order. The JAX package is imported inside the tests that
use it, so the card test runs in a process without JAX.
"""

import dataclasses
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
    r64, i64 = torch.from_numpy(rack).long(), torch.from_numpy(iid).long()
    assert r64.dtype == torch.int64
    plain = tref.ref_fleet_evaluate(r64, i64, *tables, **kw)
    np.testing.assert_array_equal(plain.numpy(), want)
    r16 = torch.from_numpy(rack.astype(np.int16))
    i32 = torch.from_numpy(iid)
    np.testing.assert_array_equal(tref.ref_fleet_evaluate(r16, i32, *tables, **kw).numpy(), want)
    packed = stage2.pack_tables(*tables)
    for r, i, t in ((r64, i64, tables), (torch.from_numpy(rack), i32, tables),
                    (r16, i32, tables), (r16, i32, (packed,))):
        got = stage2.fleet_evaluate(r, i, *t, **kw)
        assert got.dtype == torch.float32 and got.shape == (rack.shape[0],)
        np.testing.assert_array_equal(got.numpy(), want)
    assert stage2.launches == before
    assert np.isfinite(want).all()


@pytest.mark.parametrize("layout", ["packed", "scattered"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_matches_reference_at_distinct_rates(seed, layout):
    """The mixed fleets with wired and wireless rates that differ (the
    default rates are equal, so q_wired == q_wireless everywhere else):
    the plain version, on int16 rows and through the packed tables, equals
    the JAX package's compiled scan exactly."""
    insts = [dataclasses.replace(inst, wired_rate=1.0 + 0.5 * k, wireless_rate=0.5 + 0.25 * k)
             for k, inst in enumerate(_mixed_fleet(seed + 20))]
    ops = [build_op_tables(i) for i in insts]
    dims = TV._fleet_dims(insts, True, ops)
    rack, iid = _rows(np.random.default_rng(seed), insts, dims.n_pad, layout)
    _, want = _reference(insts, True, rack, iid)
    tables = TV._build_eval_stack(insts, dims, True, "cpu", ops)
    assert not torch.equal(tables[6], tables[7])
    kw = dict(m_pad=dims.m_pad, M_pad=dims.M_pad, n_chan=dims.n_chan)
    got = stage2.fleet_evaluate(torch.from_numpy(rack.astype(np.int16)), torch.from_numpy(iid),
                                stage2.pack_tables(*tables), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_stage2_is_the_wrapper():
    """``_scan_evaluate`` on the CPU is the wrapper's plain route, and
    ``_stage2_split`` hands it the int16 rows of the staging buffer and
    the packed tables there."""
    insts = _mixed_fleet(3)
    ops = [build_op_tables(i) for i in insts]
    dims = TV._fleet_dims(insts, True, ops)
    tables = TV._build_eval_stack(insts, dims, True, "cpu", ops)
    rack, iid = _rows(np.random.default_rng(4), insts, dims.n_pad, "scattered")
    kw = dict(m_pad=dims.m_pad, M_pad=dims.M_pad, n_chan=dims.n_chan)
    want = tref.ref_fleet_evaluate(torch.from_numpy(rack), torch.from_numpy(iid), *tables, **kw)
    dev = torch.device("cpu")
    rows = TV._FleetRows(rack.shape[0], dims.n_pad, dev)
    rows.rack_np[:] = rack
    rows.iid_np[:] = iid
    assert rows.rack.dtype == torch.int16 and rows.iid.dtype == torch.int32
    assert not rows.pinned
    tables_on = TV._stage2_tables(tables, [dev])
    assert isinstance(tables_on[0][0], stage2.PackedTables)
    got, = TV._stage2_split(rows.rack, rows.iid, tables_on, [dev], dims)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(rows.read([got]), want.numpy())
    assert torch.equal(TV._scan_evaluate(torch.from_numpy(rack).long(),
                                         torch.from_numpy(iid).long(), *tables, **kw), want)


def _bucket_128():
    rng = np.random.default_rng(0)
    return [ProblemInstance(job=random_job(rng, None, n_tasks=128, rho=1.0), n_racks=16,
                            n_wireless=2)]


@pytest.mark.parametrize("fleet", ["mixed0", "mixed1", "mixed2", "bucket128"])
@pytest.mark.parametrize("use_wireless", [True, False], ids=["wireless", "wired_only"])
def test_packed_tables_are_lossless(fleet, use_wireless):
    """Unpacking the kernel's records gives the 12 tables back exactly,
    over the mixed fleets and the 128-task bucket of 4,096 edges (ids up
    to the sentinel 4,096 in 16 bits); n_live is each instance's count of
    rows up to its last task or edge row."""
    insts = _bucket_128() if fleet == "bucket128" else _mixed_fleet(int(fleet[-1]))
    ops = [build_op_tables(i) for i in insts]
    dims = TV._fleet_dims(insts, use_wireless, ops)
    tables = TV._build_eval_stack(insts, dims, use_wireless, "cpu", ops)
    packed = stage2.pack_tables(*tables)
    assert packed.blob.dtype == torch.int32
    assert packed.blob.shape == (len(insts), stage2.packed_words(
        dims.n_ops, dims.indeg_pad, dims.M_pad, dims.n_chan))
    assert packed.blob.shape[1] % 4 == 0
    back = stage2.unpack_tables(packed)
    assert len(back) == len(tables) == 12
    for a, b in zip(back, tables):
        assert a.dtype == b.dtype and torch.equal(a, b)
    Q = stage2.record_quads(dims.indeg_pad)
    tail = packed.blob[:, dims.n_ops * 4 * Q:]
    assert tail[:, 0].tolist() == [o.n_ops for o in ops]  # n_live
    # Each rack's channel mask (bit c: reach 1), which the kernel ANDs.
    reach = tables[11]
    at = 1 + dims.n_chan + dims.M_pad * dims.n_chan
    mask = tail[:, at:at + dims.M_pad]
    for c in range(dims.n_chan):
        assert torch.equal((mask >> c) & 1, (reach[..., c] > 0).to(torch.int32))
    assert int(mask.max()) < 1 << dims.n_chan
    assert packed.binary_reach
    assert not stage2.pack_tables(*tables[:11], reach * 0.5).binary_reach
    if fleet == "bucket128":
        assert (dims.n_pad, dims.m_pad) == (128, 4096)
        assert int(back[9].max()) == dims.m_pad


def test_pack_refuses_ids_past_16_bits():
    rack, iid, tables, dims = _small_inputs()
    tables[2] = tables[2].clone()
    tables[2][0, 0] = 1 << 16
    with pytest.raises(ValueError, match="op_edge"):
        stage2.pack_tables(*tables)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_engine_int16_staging_equals_plain(monkeypatch, n_dev):
    """``_run_fleet``'s and ``make_batched_evaluator``'s path on the CPU:
    rows written into the int16 staging buffer (tasks past a job's n and
    unused rows on rack 0), split over ``n_dev`` chunks, scored through
    the packed tables, equal ``ref_fleet_evaluate`` on the same rows; a
    smaller fill reuses the buffer with no row of the earlier one left."""
    insts = _mixed_fleet(1)
    ops = [build_op_tables(i) for i in insts]
    dims = TV._fleet_dims(insts, True, ops)
    tables = TV._build_eval_stack(insts, dims, True, "cpu", ops)
    kw = dict(m_pad=dims.m_pad, M_pad=dims.M_pad, n_chan=dims.n_chan)
    dev = torch.device("cpu")
    devs = [dev] * n_dev
    tables_on = TV._stage2_tables(tables, devs)
    rng = np.random.default_rng(7)
    bs, B = 24, 24 * len(insts)
    rows = TV._FleetRows(B, dims.n_pad, dev)
    for n_blocks in (len(insts), 2):
        blocks = []
        for s in range(n_blocks):
            i = int(rng.integers(0, len(insts)))
            n = insts[i].job.n_tasks
            blocks.append((s * bs, rng.integers(0, insts[i].n_racks, (bs, n)), n, i))
        rows.fill(blocks, dims.n_pad)
        rack = np.zeros((B, dims.n_pad), np.int64)
        iid = np.zeros(B, np.int64)
        for lo, blk, n, i in blocks:
            rack[lo:lo + bs, :n] = blk
            iid[lo:lo + bs] = i
        np.testing.assert_array_equal(rows.rack_np, rack)
        np.testing.assert_array_equal(rows.iid_np, iid)
        want = tref.ref_fleet_evaluate(torch.from_numpy(rack), torch.from_numpy(iid), *tables,
                                       **kw)
        got = rows.read(TV._stage2_split(rows.rack, rows.iid, tables_on, devs, dims))
        np.testing.assert_array_equal(got, want.numpy())

    monkeypatch.setattr(TV, "_stage2_devices", lambda d: [d] * n_dev)
    ev = TV.make_batched_evaluator(insts[3], device="cpu")
    single = TV._fleet_dims([insts[3]], True, [ops[3]])
    one = TV._build_eval_stack([insts[3]], single, True, "cpu", [ops[3]])
    for B in (37, 5, 64):
        cands = rng.integers(0, insts[3].n_racks, (B, insts[3].job.n_tasks))
        rack = np.zeros((B, single.n_pad), np.int64)
        rack[:, :cands.shape[1]] = cands
        want = tref.ref_fleet_evaluate(torch.from_numpy(rack), torch.zeros(B, dtype=torch.int64),
                                       *one, m_pad=single.m_pad, M_pad=single.M_pad,
                                       n_chan=single.n_chan)
        assert torch.equal(ev(cands), want)


def test_int16_rack_range():
    """The int16 racks lose nothing: the state limit refuses M_pad 65,536
    and admits 32,768, where rack 32,767 (the largest int16) scores as it
    does through int64 racks."""
    insts = _mixed_fleet(0)[:2]
    ops = [build_op_tables(i) for i in insts]
    dims = TV._fleet_dims(insts, True, ops)
    tables = list(TV._build_eval_stack(insts, dims, True, "cpu", ops))
    rng = np.random.default_rng(3)
    rack, iid = _rows(rng, insts, dims.n_pad, "scattered")
    for M_pad in (65536, 32768):
        reach = torch.ones((len(insts), M_pad, dims.n_chan), dtype=torch.float32)
        reach[:, :dims.M_pad] = tables[11]
        t = tables[:11] + [reach]
        kw = dict(m_pad=dims.m_pad, M_pad=M_pad, n_chan=dims.n_chan)
        if M_pad == 65536:
            assert stage2.state_words(dims.n_pad, dims.m_pad, M_pad, dims.n_chan) > \
                stage2.MAX_STATE_WORDS
            with pytest.raises(ValueError, match="exceeds the kernel"):
                stage2.fleet_evaluate(torch.from_numpy(rack.astype(np.int16)),
                                      torch.from_numpy(iid), *t, **kw)
            continue
        big = rack.copy()
        big[::3, 0] = M_pad - 1
        big[1::3, 1] = M_pad - 2
        r16 = torch.from_numpy(big.astype(np.int16))
        assert int(r16.max()) == 32767
        want = tref.ref_fleet_evaluate(torch.from_numpy(big).long(),
                                       torch.from_numpy(iid).long(), *t, **kw)
        packed = stage2.pack_tables(*t)
        assert torch.equal(stage2.fleet_evaluate(r16, torch.from_numpy(iid), *t, **kw), want)
        assert torch.equal(stage2.fleet_evaluate(r16, torch.from_numpy(iid), packed, **kw),
                           want)
        assert torch.isfinite(want).all()


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
     "op_in_shape", "chan_shape", "reach_shape", "device", "noncontig", "state_too_big",
     "packed_dtype", "packed_shape", "packed_dims", "table_count"],
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
    elif bad.startswith("packed"):
        packed = stage2.pack_tables(*tables)
        if bad == "packed_dtype":
            packed, err = dataclasses.replace(packed, blob=packed.blob.long()), TypeError
        elif bad == "packed_shape":
            packed = dataclasses.replace(packed, blob=packed.blob[:, :-4].contiguous())
        else:
            packed, match = dataclasses.replace(packed, n_chan=2), "n_chan 2"
        tables = [packed]
    elif bad == "table_count":
        tables, err = tables[:11], TypeError
    with pytest.raises(err, match=match):
        stage2.fleet_evaluate(rack, iid, *tables, **kw)


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version_on_card():
    """On a card: the kernel equals ``ref_fleet_evaluate`` bit for bit over
    size buckets (n_pad 8 to 128, so blocks of 128 rows down to 4; M_pad 2
    to 16; n_chan 1 to 6, past the 4 the kernel unrolls; with and without
    a topology, a masked wireless column where an instance has fewer
    channels; one instance at distinct wired and wireless rates), on the
    engine's inputs (int16 rows through ``_FleetRows``, the packed tables
    of ``_stage2_tables``): rows packed 64 an instance, B = 203 rows of
    random instances (no multiple of a block; rows of other instances read
    their blob in place), and rows packed as the serving shape (B = 4,096)
    and B = 1. One launch a call; int32 and int64 racks and the 12 tables
    raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU route is covered above)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = 0
    for n_tasks in (3, 8, 16, 31, 64, 128):
        for n_racks in (2, 5, 16):
            for n_wireless, topo in ((0, False), (1, True), (2, False), (2, True), (5, True)):
                insts = [_instance(rng, n_tasks, n_racks, n_wireless, topo),
                         _instance(rng, max(2, n_tasks // 2), max(1, n_racks - 1),
                                   max(0, n_wireless - 1), topo),
                         _instance(rng, max(2, n_tasks - 1), n_racks, n_wireless, False,
                                   edgeless=True)]
                # Wired and wireless durations that differ on one instance.
                insts.append(dataclasses.replace(insts[0], wired_rate=2.0, wireless_rate=0.5))
                ops = [build_op_tables(i) for i in insts]
                dims = TV._fleet_dims(insts, True, ops)
                tables = TV._build_eval_stack(insts, dims, True, dev, ops)
                packed, = TV._stage2_tables(
                    TV._build_eval_stack(insts, dims, True, "cpu", ops), [dev])[0]
                kw = dict(m_pad=dims.m_pad, M_pad=dims.M_pad, n_chan=dims.n_chan)
                for layout in ("packed", "scattered", "serving", "one"):
                    if layout in ("packed", "scattered"):
                        rack, iid = _rows(rng, insts, dims.n_pad, layout)
                    else:
                        B = 4096 if layout == "serving" else 1
                        iid = np.repeat(np.arange(len(insts)), -(-B // len(insts)))[:B]
                        rack = np.zeros((B, dims.n_pad), np.int32)
                        for b, i in enumerate(iid):
                            n = insts[i].job.n_tasks
                            rack[b, :n] = rng.integers(0, insts[i].n_racks, n)
                    rows = TV._FleetRows(rack.shape[0], dims.n_pad, dev)
                    assert rows.pinned and rows.rack.is_pinned()
                    rows.rack_np[:] = rack
                    rows.iid_np[:] = iid
                    r16 = rows.rack.to(dev, non_blocking=True)
                    i32 = rows.iid.to(dev, non_blocking=True)
                    assert r16.dtype == torch.int16 and i32.dtype == torch.int32
                    want = tref.ref_fleet_evaluate(r16, i32, *tables, **kw)
                    before = stage2.launches["fleet_evaluate"]
                    got = stage2.fleet_evaluate(r16, i32, packed, **kw)
                    assert torch.equal(got, want), (n_tasks, n_racks, n_wireless, topo, layout)
                    assert stage2.launches["fleet_evaluate"] == before + 1
                    for wide in (torch.int32, torch.int64):
                        with pytest.raises(TypeError):
                            stage2.fleet_evaluate(r16.to(wide), i32.to(wide), packed, **kw)
                    with pytest.raises(TypeError):
                        stage2.fleet_evaluate(r16, i32, *tables, **kw)
                    assert stage2.launches["fleet_evaluate"] == before + 1
                    cases += 1
    torch.cuda.synchronize()
    assert cases == 360
