"""Stage 1 of the port's fleet engine in one launch.

The fused kernel ``cpm_fleet_lb`` / ``cpm_fleet_lb_masked`` computes the
JAX package's whole stage-1 device program
(``repro.core.vectorized._fleet_lb_device``: adjacency and mask scatter,
contention terms, Pallas relaxation) from the candidates' racks and the
per-instance edge tables. Its plain version ``ref_fleet_lb`` is the CPU
route of the port's ``_fleet_lb_device``; here it is held against the JAX
package on a mixed fleet (also on the engine's int16 rows and packed
tables), and the wrapper's checks and routes, the packing (lossless, its
refusals), the engine's row buffer and a numpy model of the kernel's walk
over the packed tables are tested. On a card the kernels are held against
their plain versions.

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
        torch.from_numpy(rack).long(), torch.from_numpy(iid).long(),
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
    """On a card: the fused kernel, on int16 rows, int32 instance ids and
    the packed tables, equals ``ref_fleet_lb`` bit for bit over n_pad
    (1 to 128, multiples of 8 with the racks by bulk copy and others
    without), rack buckets (M_pad 40: the float pair_ok table instead of
    the masks), round counts, both bodies and contention on and off; B =
    203 is no multiple of any block's rows, the rows in random instance
    order (every block spans several instances) and sorted (a block one
    instance, some spanning two). The kernel takes int16 rows and the
    packed tables only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU route is covered above)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    B = 203
    for n_pad in (1, 5, 8, 16, 17, 32, 33, 64, 128):
        for M_pad in (2, 8, 16, 40):
            m_pad = max(8, min(4 * n_pad, 256))
            racks, inst, tables, pair_ok, uplift = synthetic_stage1(
                rng, 5, n_pad, m_pad, M_pad, B)
            order = torch.argsort(inst, stable=True)
            for layout in ("random", "sorted"):
                r, i = (racks, inst) if layout == "random" else (racks[order], inst[order])
                r, i = r.contiguous().to(dev), i.contiguous().to(dev)
                r16, i32 = r.short(), i.int()
                for topo in ((), (pair_ok, uplift)):
                    plain = tuple(t.to(dev) for t in tables + topo)
                    packed = cpm.pack_lb_tables(*tables, *topo).to(dev)
                    assert packed.pair_route == (None if not topo else
                                                 "masks" if M_pad <= 32 else "table")
                    for n_iters in sorted({0, 1, n_pad - 1}):
                        for contention in (True, False):
                            kw = dict(M_pad=M_pad, n_iters=n_iters, contention=contention)
                            key = "fleet_lb_masked" if topo else "fleet_lb"
                            before = cpm.launches[key]
                            want = tref.ref_fleet_lb(r, i, *plain, **kw)
                            got = cpm.fleet_combined_lb(r16, i32, packed, **kw)
                            assert torch.equal(got, want), (n_pad, M_pad, layout, n_iters,
                                                            topo != (), contention)
                            assert cpm.launches[key] == before + 1
                    for bad in ((r, i, packed), (r.int(), i32, packed), (r16, i32, *plain)):
                        with pytest.raises(TypeError):
                            cpm.fleet_combined_lb(*bad, **kw)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The packed tables, the int16 rows and the engine's row buffer
# ---------------------------------------------------------------------------

def _bucket_128():
    rng = np.random.default_rng(5)
    return [R.ProblemInstance(job=R.random_job(rng, None, n_tasks=100, rho=1.0), n_racks=16,
                              n_wireless=2)]


def _packing_fleet(fleet):
    """Stage-1 tables of a named fleet: the mixed fleets with and without a
    topology, an edgeless job alone, the 128-task bucket and synthetic
    tables past the 32-rack masks."""
    if fleet == "synthetic40":
        _, _, tables, pair_ok, uplift = synthetic_stage1(np.random.default_rng(1), 5, 16, 32,
                                                         40, 8)
        return tables + (pair_ok, uplift), 40
    insts = {"mixed_topology": lambda: _mixed_fleet(True),
             "mixed": lambda: _mixed_fleet(False),
             "edgeless": lambda: [_instance(3, 6, 2, 1, False, edgeless=True)],
             "bucket128": _bucket_128}[fleet]()
    tinsts = [instance_from_arrays(instance_to_arrays(i)) for i in insts]
    dims = TV._fleet_dims(tinsts, use_wireless=True)
    return TV._build_lb_arrays(tinsts, dims, "cpu"), dims.M_pad


@pytest.mark.parametrize("fleet", ["mixed_topology", "mixed", "edgeless", "bucket128",
                                   "synthetic40"])
def test_packed_lb_tables_are_lossless(fleet):
    """Unpacking gives the tables back exactly; the kernel section holds
    each edge's two cells as the one float32 add of the reference, the
    relaxation columns (every task with in-edges, then one for all tasks
    without) and their in-edge lists, and, under a topology of at most 32
    racks, each rack's connectivity mask."""
    tables, M_pad = _packing_fleet(fleet)
    packed = cpm.pack_lb_tables(*tables)
    at = packed.layout
    assert packed.blob.dtype == torch.int32 and packed.blob.shape[1] == at["words"]
    assert at["words"] % 4 == 0 and at["kernel_words"] % 4 == 0
    back = cpm.unpack_lb_tables(packed)
    assert len(back) == len(tables)
    for a, b in zip(back, tables):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(packed.tables[0], tables[0])
    src, dst, p_src, c_local, c_net, net_work, p_task = tables[:7]
    n_pad, m_pad = packed.n_pad, packed.m_pad
    rec = packed.blob[:, at["rec"]:at["col_cnt"]].reshape(-1, m_pad, 4)
    assert torch.equal(rec[..., 1].view(torch.float32), tref._finite(c_local + p_src))
    assert torch.equal(rec[..., 2].view(torch.float32), tref._finite(c_net + p_src))
    for i in range(src.shape[0]):
        real = (src[i] != dst[i]).nonzero().flatten().tolist()
        has_in = sorted({int(dst[i, e]) for e in real})
        n0 = n_pad - len(has_in)
        head = packed.blob[i, :3].tolist()
        assert head == [len(has_in) + (n0 > 0), max(real) + 1 if real else 0,
                        int((p_task[i] != 0).nonzero().max()) + 1]
        level = [0] * n_pad
        for _ in range(n_pad):
            for e in real:
                level[int(dst[i, e])] = max(level[int(dst[i, e])], level[int(src[i, e])] + 1)
        assert int(packed.blob[i, 4]) == max(level)
        cnt = packed.blob[i, at["col_cnt"]:at["col_cnt"] + len(has_in)].tolist()
        assert cnt == [sum(int(dst[i, e]) == v for e in real) for v in has_in]
        col_p = packed.blob[i, at["col_p"]:at["col_in"]].view(torch.float32)
        assert col_p[:len(has_in)].tolist() == p_task[i, has_in].tolist()
        if n0:
            rest = [v for v in range(n_pad) if v not in has_in]
            assert float(col_p[len(has_in)]) == float(p_task[i, rest].max())
        ent = packed.blob[i, at["col_in"]:at["col_in"] + len(real)].tolist()
        slot = {v: j for j, v in enumerate(has_in)}
        want = sorted(real, key=lambda e: (slot[int(dst[i, e])], e))
        assert [x >> 16 for x in ent] == want
        assert [x & 0xFFFF for x in ent] == [slot.get(int(src[i, e]), len(has_in)) for e in want]
    assert packed.pair_route == (None if len(tables) == 8 else
                                 "masks" if M_pad <= cpm.MAX_MASK_RACKS else "table")
    if packed.pair_route == "masks":
        mask = packed.blob[:, at["mask"]:at["mask"] + M_pad].to(torch.int64) & 0xFFFFFFFF
        for v in range(M_pad):
            assert torch.equal((mask >> v) & 1, (tables[8][..., v] > 0.5).to(torch.int64))
    if fleet == "bucket128":
        assert (n_pad, m_pad) == (128, 2048)


@pytest.mark.parametrize("bad", ["task_id", "negative_id", "edge_ids", "repeated_edge",
                                 "low_cell", "low_uplift_cell"])
def test_pack_lb_refuses_what_does_not_fit(bad):
    rng = np.random.default_rng(2)
    _, _, tables, pair_ok, uplift = synthetic_stage1(rng, 3, 8, 8, 4, 4)
    tables = [t.clone() for t in tables]
    topo = []
    if bad == "task_id":
        tables[1][1, 0] = 8
    elif bad == "negative_id":
        tables[0][1, 0] = -1
    elif bad == "edge_ids":
        tables = [torch.zeros((1, 65537), dtype=t.dtype) if t.dim() == 2 and t.shape[1] == 8
                  and k != 6 else t[:1] for k, t in enumerate(tables)]
    elif bad == "repeated_edge":
        i = int((tables[0] != tables[1]).sum(dim=1).argmax())
        tables[0][i, 1], tables[1][i, 1] = tables[0][i, 0], tables[1][i, 0]
    elif bad == "low_cell":
        i, e = (tables[0] != tables[1]).nonzero()[0].tolist()
        tables[4][i, e] = -1e31
    else:
        i, e = (tables[0] != tables[1]).nonzero()[0].tolist()
        uplift = uplift.clone()
        uplift[i, e] = -3e38
        topo = [pair_ok, uplift]
    with pytest.raises(ValueError, match="does not pack"):
        cpm.pack_lb_tables(*tables, *topo)


def test_pair_masks_refuse_racks_past_the_mask():
    pair_ok = torch.ones((2, 33, 33))
    with pytest.raises(ValueError, match="32-bit"):
        cpm.pair_masks(pair_ok)
    masks = cpm.pair_masks(pair_ok[:, :32, :32])
    assert masks.dtype == torch.int32 and bool((masks == -1).all())


@pytest.mark.parametrize("topo", [True, False], ids=["mixed_topology", "no_topology"])
@pytest.mark.parametrize("contention", [True, False])
def test_plain_route_on_int16_rows_matches_reference(topo, contention):
    """The engine's inputs (int16 racks, int32 instance ids, the packed
    tables, which the CPU route unpacks) give the JAX package's bounds."""
    insts = _mixed_fleet(topo)
    tinsts = [instance_from_arrays(instance_to_arrays(i)) for i in insts]
    dims = RV._fleet_dims(insts, use_wireless=True)
    rack, iid = _candidates(np.random.default_rng(11), insts, dims.n_pad, 24, 5)
    kw = dict(M_pad=dims.M_pad, n_iters=dims.n_iters, block_b=8, contention=contention)
    want = np.asarray(RV._fleet_lb_device(
        jnp.asarray(rack), jnp.asarray(iid), *RV._build_lb_arrays(insts, dims), **kw))
    r16, i32 = torch.from_numpy(rack.astype(np.int16)), torch.from_numpy(iid)
    before = dict(cpm.launches)
    for tables in (TV._lb_tables(tinsts, dims, "cpu"), TV._build_lb_arrays(tinsts, dims, "cpu")):
        got = TV._fleet_lb_device(r16, i32, *tables, **kw)
        np.testing.assert_array_equal(got.numpy(), want)
    assert cpm.launches == before


def test_engine_stage1_rows_through_the_row_buffer():
    """``_run_fleet``'s stage-1 rows on the CPU: pieces written into the
    shared row buffer (tasks past a job's n and the rows after a piece on
    rack 0, its instance id over its whole block, unused blocks on rack 0
    of instance 0), a smaller fill after a larger one, give
    ``ref_fleet_lb``'s bounds on the same rows through the packed tables."""
    insts = [instance_from_arrays(instance_to_arrays(i)) for i in _mixed_fleet(True)]
    dims = TV._fleet_dims(insts, use_wireless=True)
    tables = TV._build_lb_arrays(insts, dims, "cpu")
    packed = TV._lb_tables(insts, dims, "cpu")
    kw = dict(M_pad=dims.M_pad, n_iters=dims.n_iters, block_b=8, contention=True)
    rng = np.random.default_rng(4)
    bs, I = 16, len(insts)
    rows = TV._FleetRows(I * bs, dims.n_pad, torch.device("cpu"))
    assert rows.rack.dtype == torch.int16 and rows.iid.dtype == torch.int32
    for n_blocks in (I, 2):
        pieces = []
        for s in range(n_blocks):
            i = int(rng.integers(0, I))
            n = insts[i].job.n_tasks
            pieces.append((s * bs, rng.integers(0, insts[i].n_racks, (bs - s, n)), n, i))
        rows.fill(pieces, dims.n_pad, span=bs)
        rack = np.zeros((I * bs, dims.n_pad), np.int64)
        iid = np.zeros(I * bs, np.int64)
        for lo, cands, n, i in pieces:
            rack[lo:lo + len(cands), :n] = cands
            iid[lo:lo + bs] = i
        np.testing.assert_array_equal(rows.rack_np, rack)
        np.testing.assert_array_equal(rows.iid_np, iid)
        want = tref.ref_fleet_lb(torch.from_numpy(rack), torch.from_numpy(iid), *tables,
                                 M_pad=dims.M_pad, n_iters=dims.n_iters, contention=True)
        got = rows.read([TV._fleet_lb_device(rows.rack, rows.iid, *packed, **kw)])
        np.testing.assert_array_equal(got, want.numpy())


def _walk_model(racks, iid, packed, M_pad, n_iters, contention):
    """A numpy model of ``cpm_fleet_kernel``'s walk over the packed kernel
    section (csrc/cpm.cu ``fleet_row``), row by row in float32: the edges
    in edge order, the per-rack loads, the rounds over the relaxation
    columns with the absent cells' term T, stopped after depth rounds
    (while the dists stay at most 1e30) or at a fixed point, the columns'
    epilogue."""
    with np.errstate(over="ignore"):
        return _walk_rows(racks, iid, packed, M_pad, n_iters, contention)


def _walk_rows(racks, iid, packed, M_pad, n_iters, contention):
    f32 = np.float32
    blob = packed.blob.numpy()
    at = packed.layout
    out = np.empty(len(iid), f32)
    for b, (rk, i) in enumerate(zip(racks, iid)):
        kb = blob[i]
        n_cols, m_walk, n_loads, _, depth = (int(x) for x in kb[:5])
        chan_div = kb[3:4].view(f32)[0]
        rec = kb[at["rec"]:at["col_cnt"]].reshape(-1, 4)
        up = kb[at["uplift"]:at["uplift"] + packed.m_pad].view(f32)
        w = np.zeros(packed.m_pad, f32)
        work = forced = f32(0)
        for e in range(m_walk):
            s, t = int(rec[e, 0]) & 0xFFFF, (int(rec[e, 0]) >> 16) & 0xFFFF
            same = rk[s] == rk[t]
            cell = rec[e, 1:2].view(f32)[0] if same else rec[e, 2:3].view(f32)[0]
            ne = rec[e, 3:4].view(f32)[0]
            if packed.topo:
                pok = kb[at["pair_ok"]:at["pair_ok"] + M_pad * M_pad].view(f32)
                ok = pok[rk[s] * M_pad + rk[t]] > 0.5
                cell = cell + (f32(0) if same or ok else up[e])
                ne = ne + (f32(0) if ok else up[e])
                forced = forced + (f32(0) if same or ok else ne)
            work = work + (f32(0) if same else ne)
            w[e] = cell
        extra = f32(-np.inf)
        if contention:
            load = np.zeros(M_pad, f32)
            pt = kb[at["p_task"]:at["p_task"] + packed.n_pad].view(f32)
            for v in range(n_loads):
                if 0 <= rk[v] < M_pad:
                    load[rk[v]] = load[rk[v]] + pt[v]
            extra = max(load.max(), work / chan_div, forced if packed.topo else f32(-np.inf))
        cnt = kb[at["col_cnt"]:at["col_cnt"] + n_cols]
        ent = kb[at["col_in"]:at["col_in"] + packed.m_pad]
        d = np.zeros(n_cols, f32)
        M = f32(0)
        for it in range(n_iters):
            if it >= depth and M <= f32(-tref.NEG_INF):
                break
            T = M + f32(tref.NEG_INF)
            nd = np.maximum(d, T)
            k = 0
            for j in range(n_cols):
                for _ in range(int(cnt[j])):
                    nd[j] = max(nd[j], d[int(ent[k]) & 0xFFFF] + w[int(ent[k]) >> 16])
                    k += 1
            changed = not np.array_equal(nd.view(np.int32), d.view(np.int32))
            d, M = nd, nd.max()
            if not changed:
                break
        cp = kb[at["col_p"]:at["col_p"] + n_cols].view(f32)
        out[b] = max((d + cp).max(), extra if np.isfinite(extra) else f32(tref.NEG_INF))
    return out


@pytest.mark.parametrize("cells", ["usual", "huge"])
@pytest.mark.parametrize("n_pad,M_pad,m_pad", [(5, 2, 8), (16, 8, 32), (33, 40, 64)])
def test_kernel_walk_model_equals_dense_relaxation(n_pad, M_pad, m_pad, cells):
    """The kernel's sparse rounds (its in-edge lists, one column for the
    tasks without in-edges, the absent cells' term T) give the dense
    relaxation bit for bit, modelled in numpy on the packed blob: at usual
    cells, and at cells so large (1e37) that dists pass 1e30 and T, not an
    edge, decides columns."""
    rng = np.random.default_rng(n_pad + M_pad)
    racks, inst, tables, pair_ok, uplift = synthetic_stage1(rng, 5, n_pad, m_pad, M_pad, 48)
    if cells == "huge":
        tables = list(tables)
        tables[4] = tables[4] * np.float32(1e36)
        tables = tuple(tables)
    for topo in ((), (pair_ok, uplift)):
        packed = cpm.pack_lb_tables(*tables, *topo)
        for n_iters in sorted({0, 1, n_pad - 1}):
            for contention in (True, False):
                kw = dict(M_pad=M_pad, n_iters=n_iters, contention=contention)
                want = tref.ref_fleet_lb(racks, inst, *tables, *topo, **kw).numpy()
                got = _walk_model(racks.numpy(), inst.numpy(), packed, **kw)
                np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
