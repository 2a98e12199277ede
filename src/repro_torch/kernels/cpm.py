"""Batched critical path, the fused §IV-A combined bound and the fleet
engine's stage 1: wrappers of the hand-written CUDA kernels in
``csrc/cpm.cu``.

:func:`batched_critical_path` and :func:`batched_combined_lb` mirror the
JAX package's public wrappers over ``[B, n, n]`` tiles (re-exported by
:mod:`repro_torch.kernels.ops`). :func:`fleet_combined_lb` is the device
program of the scheduler's stage 1
(``repro_torch.core.vectorized._fleet_lb_device``) in one launch: it takes
the candidates' racks and instance ids and the per-instance edge tables,
and never forms the ``[B, n, n]`` adjacency.

On the card stage 1 reads the racks as int16, the instance ids as int32
and the edge tables packed once a fleet by :func:`pack_lb_tables`: one
16-byte-aligned blob an instance holding a record an edge (``src | dst``
in 16-bit halves, the co-located and the cross-rack adjacency cell, the
edge's network work), the DAG's in-edge lists by destination column, the
task durations, ``chan_div`` and, under a topology, the uplift and each
rack's connectivity mask (or, past 32 racks, the float ``pair_ok`` table);
:func:`unpack_lb_tables` gives the tables back bit for bit.

A CUDA tensor goes to the kernel (built on first use by
:mod:`repro_torch.kernels.build`) or raises; a CPU tensor goes to the
plain PyTorch version in :mod:`repro_torch.kernels.ref`. There is no
fallback from one to the other. ``launches`` counts kernel launches per
entry point and is touched nowhere else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import ref

__all__ = [
    "batched_critical_path",
    "batched_combined_lb",
    "fleet_combined_lb",
    "fleet_launch_plan",
    "launches",
    "lb_layout",
    "MAX_N",
    "MAX_MASK_RACKS",
    "PackedLB",
    "pack_lb_tables",
    "pair_masks",
    "unpack_lb_tables",
]

# Kernel launches per entry point (plain integers; the CPU route adds 0).
launches = {
    "combined_lb": 0,
    "combined_lb_masked": 0,
    "critical_path": 0,
    "fleet_lb": 0,
    "fleet_lb_masked": 0,
}

# Largest node count the kernels take (above 32, one thread per node and
# the row's tile in shared memory); the engine's size buckets stay far
# below it.
MAX_N = 128


def _check(
    name: str, t: torch.Tensor, shape: tuple, device: torch.device,
    dtypes: tuple = (torch.float32,),
) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_w(w: torch.Tensor) -> tuple[int, int]:
    if not isinstance(w, torch.Tensor) or w.dim() != 3 or w.shape[1] != w.shape[2]:
        raise ValueError("w must be a [B, n, n] tensor")
    B, n = int(w.shape[0]), int(w.shape[1])
    if not 1 <= n <= MAX_N:
        raise ValueError(f"n must be in [1, {MAX_N}], got {n}")
    _check("w", w, (B, n, n), w.device)
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {w.device}")
    return B, n


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_if(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError {err}")


def batched_critical_path(
    w: torch.Tensor, block_b: int = 8, n_iters: int | None = None
) -> torch.Tensor:
    """dist[B, n]: longest path into each node after ``n_iters`` Bellman
    max-plus rounds (default n - 1). ``block_b`` is accepted for signature
    parity with the JAX package; the CUDA kernel sizes its own blocks."""
    B, n = _check_w(w)
    iters = ref.clamp_iters(n, n_iters)
    if w.device.type == "cpu":
        return ref.ref_critical_path(w, iters)
    from repro_torch.kernels.build import load_cpm

    out = torch.empty((B, n), dtype=torch.float32, device=w.device)
    lib = load_cpm()
    err = lib.cpm_critical_path(
        w.data_ptr(), out.data_ptr(), B, n, iters, _stream(w.device)
    )
    _raise_if(err, "cpm_critical_path")
    launches["critical_path"] += 1
    return out


def batched_combined_lb(
    w: torch.Tensor,      # [B, n, n] float32 max-plus adjacency (-inf = no edge)
    p: torch.Tensor,      # [B, n] float32 per-row task durations (0 on padding)
    extra: torch.Tensor,  # [B] or [B, 1] float32 contention bound (-inf to disable)
    mask: torch.Tensor | None = None,  # [B, n, n] float32 feasibility uplift
    block_b: int = 8,
    n_iters: int | None = None,
) -> torch.Tensor:
    """lb[B] = max(max_v dist[v] + p[v], extra): the §IV-A combined
    stage-1 bound, relaxed over ``w + mask`` when a mask is given.
    ``block_b`` and ``n_iters`` as in :func:`batched_critical_path`."""
    B, n = _check_w(w)
    dev = w.device
    _check("p", p, (B, n), dev)
    if tuple(extra.shape) == (B, 1):
        extra = extra.reshape(B)
    _check("extra", extra, (B,), dev)
    if mask is not None:
        _check("mask", mask, (B, n, n), dev)
    iters = ref.clamp_iters(n, n_iters)
    if dev.type == "cpu":
        return ref.ref_combined_lb(w, p, extra, mask=mask, n_iters=iters)
    from repro_torch.kernels.build import load_cpm

    out = torch.empty((B,), dtype=torch.float32, device=dev)
    lib = load_cpm()
    if mask is None:
        err = lib.cpm_combined_lb(
            w.data_ptr(), p.data_ptr(), extra.data_ptr(), out.data_ptr(),
            B, n, iters, _stream(dev),
        )
        _raise_if(err, "cpm_combined_lb")
        launches["combined_lb"] += 1
    else:
        err = lib.cpm_combined_lb_masked(
            w.data_ptr(), mask.data_ptr(), p.data_ptr(), extra.data_ptr(),
            out.data_ptr(), B, n, iters, _stream(dev),
        )
        _raise_if(err, "cpm_combined_lb_masked")
        launches["combined_lb_masked"] += 1
    return out




# ---------------------------------------------------------------------------
# Stage 1: the packed tables and the fused kernel
# ---------------------------------------------------------------------------

# Most racks whose connectivity fits one 32-bit mask a rack; past it the
# kernel reads the float pair_ok table of the blob (csrc/cpm.cu kMaskRacks).
MAX_MASK_RACKS = 32
# How the kernel reads an edge's rack-pair connectivity (PackedLB.topo).
TOPO_NONE, TOPO_MASKS, TOPO_TABLE = 0, 1, 2
# Largest shared memory a block may ask for on sm_90 (csrc/cpm.cu kSmemMax):
# one row's stage-1 state (fleet_state_words) and the mbarrier must fit.
_SMEM_MAX = 232448
_U16 = 0xFFFF
_TABLES = ("src", "dst", "p_src", "c_local", "c_net", "net_work", "p_task", "chan_div",
           "pair_ok", "uplift")


def _word(w: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values (int64) as the int32 words of the same bits."""
    w = w.to(torch.int64)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _pair(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two 16-bit fields in one int32 word (lo in bits 0-15)."""
    return _word(lo.to(torch.int64) | (hi.to(torch.int64) << 16))


def _halves(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    w = w.to(torch.int64)
    return w & _U16, (w >> 16) & _U16


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous().view(torch.int32)


def _floats(w: torch.Tensor) -> torch.Tensor:
    return w.contiguous().view(torch.float32)


def _quad(words: int) -> int:
    return -(-words // 4) * 4


def lb_layout(n_pad: int, m_pad: int, M_pad: int, topo: int) -> dict[str, int]:
    """Word offsets in one instance's packed stage-1 blob (the kernel's
    ``Layout``, csrc/cpm.cu). The kernel section, which a block stages:
    head (n_cols, m_walk, n_loads, chan_div, depth, 3 unused words), rec
    [m_pad] quads (src |
    dst << 16, co-located cell, cross-rack cell, net_work), col_cnt and
    col_p [n_pad + 1] (each relaxation column's in-edge count and
    duration), col_in [m_pad] (in-edge entries, slot of src | e << 16,
    column after column), p_task [n_pad], under a topology uplift
    [m_pad] and with TOPO_MASKS mask [M_pad]; ``kernel_words`` ends it.
    Then what only :func:`unpack_lb_tables` (and, with TOPO_TABLE, the
    kernel) reads: c_local, c_net, p_src [m_pad] and pair_ok [M_pad,
    M_pad]; ``words`` ends the blob. Both ends are multiples of 4."""
    at = {"rec": 8}
    at["col_cnt"] = at["rec"] + 4 * m_pad
    at["col_p"] = at["col_cnt"] + n_pad + 1
    at["col_in"] = at["col_p"] + n_pad + 1
    at["p_task"] = at["col_in"] + m_pad
    at["uplift"] = at["p_task"] + n_pad
    at["mask"] = at["uplift"] + (m_pad if topo else 0)
    at["kernel_words"] = _quad(at["mask"] + (M_pad if topo == TOPO_MASKS else 0))
    at["c_local"] = at["kernel_words"]
    at["c_net"] = at["c_local"] + m_pad
    at["p_src"] = at["c_net"] + m_pad
    at["pair_ok"] = at["p_src"] + m_pad
    at["words"] = _quad(at["pair_ok"] + (M_pad * M_pad if topo else 0))
    return at


def fleet_state_words(n_pad: int, m_pad: int) -> int:
    """Shared-memory words one row holds in the fused kernel: its racks
    [n_pad], edge cells [m_pad] and two rounds of dist [n_pad + 1]."""
    return 3 * n_pad + 2 + m_pad


@dataclasses.dataclass(frozen=True, eq=False)
class PackedLB:
    """The stage-1 tables of a fleet as the kernel reads them: ``blob``
    int32 [I, lb_layout(...)["words"]], one 16-byte-aligned blob an
    instance. ``topo`` is TOPO_NONE without a topology, else TOPO_MASKS
    (M_pad <= 32: a connectivity mask a rack) or TOPO_TABLE (the float
    pair_ok table); ``M_pad`` is that of pair_ok (None without one)."""

    blob: torch.Tensor
    n_pad: int
    m_pad: int
    M_pad: int | None
    topo: int

    def to(self, device) -> "PackedLB":
        return dataclasses.replace(self, blob=self.blob.to(device))

    @property
    def layout(self) -> dict[str, int]:
        return lb_layout(self.n_pad, self.m_pad, self.M_pad or 0, self.topo)

    @property
    def pair_route(self) -> str | None:
        """How the kernel reads a rack pair's connectivity: "masks",
        "table", or None without a topology."""
        return {TOPO_NONE: None, TOPO_MASKS: "masks", TOPO_TABLE: "table"}[self.topo]

    @functools.cached_property
    def tables(self) -> tuple:
        """The tables back (what the plain version reads), once."""
        return unpack_lb_tables(self)


def _check_tables(tables: tuple, n_pad: int, dev: torch.device) -> tuple:
    """The 8 stage-1 tables, or 10 with ``pair_ok`` and ``uplift`` (both
    None counts as 8), checked; returns them and M_pad of pair_ok (None
    without one)."""
    if len(tables) == 10 and tables[8] is None and tables[9] is None:
        tables = tables[:8]
    if len(tables) == 10 and (tables[8] is None or tables[9] is None):
        raise ValueError("pair_ok and uplift go together")
    if len(tables) not in (8, 10):
        raise TypeError(f"expected the 8 or 10 stage-1 tables or one PackedLB, got "
                        f"{len(tables)} table arguments")
    src = tables[0]
    if not isinstance(src, torch.Tensor) or src.dim() != 2:
        raise ValueError("src must be an [I, m_pad] tensor")
    I, m_pad = int(src.shape[0]), int(src.shape[1])
    _check("src", src, (I, m_pad), dev, (torch.int64,))
    _check("dst", tables[1], (I, m_pad), dev, (torch.int64,))
    for name, t in zip(_TABLES[2:6], tables[2:6]):
        _check(name, t, (I, m_pad), dev)
    _check("p_task", tables[6], (I, n_pad), dev)
    _check("chan_div", tables[7], (I,), dev)
    M_pad = None
    if len(tables) == 10:
        pair_ok = tables[8]
        if not isinstance(pair_ok, torch.Tensor) or pair_ok.dim() != 3:
            raise ValueError("pair_ok must be an [I, M_pad, M_pad] tensor")
        M_pad = int(pair_ok.shape[1])
        _check("pair_ok", pair_ok, (I, M_pad, M_pad), dev)
        _check("uplift", tables[9], (I, m_pad), dev)
    return tables, M_pad


def pair_masks(pair_ok: torch.Tensor) -> torch.Tensor:
    """int32 [I, M_pad]: bit rv of mask[i, ru] is pair_ok[i, ru, rv] > 0.5
    (the kernel's connectivity test, one AND a lookup). Refuses M_pad past
    MAX_MASK_RACKS, where a mask has no bit for every rack."""
    M_pad = int(pair_ok.shape[-1])
    if M_pad > MAX_MASK_RACKS:
        raise ValueError(f"M_pad {M_pad} does not fit a {MAX_MASK_RACKS}-bit rack mask")
    weights = torch.tensor([1 << v for v in range(M_pad)], dtype=torch.int64,
                           device=pair_ok.device)
    return _word(((pair_ok > 0.5).to(torch.int64) * weights).sum(dim=-1))


def pack_lb_tables(*tables) -> PackedLB:
    """Pack the stage-1 tables of ``_build_lb_arrays`` (once a fleet) into
    the blobs the kernel reads, on the tables' device (:func:`lb_layout`).

    Derived, per instance: each edge's two adjacency cells
    ``finite_or_neg(c_local + p_src)`` and ``finite_or_neg(c_net + p_src)``
    (the one float32 add the reference makes, so the same bits); the
    relaxation columns, one a task with in-edges (increasing task id) and,
    when some task has none, one more standing for all such tasks, whose
    dist is always equal (each starts at 0 and takes the same update), its
    duration their largest; each edge's entry in its destination's in-edge
    list (edges with src == dst write no cell and add 0 to every sum: none
    is listed); m_walk and n_loads, the edges and tasks up to the last one
    that is not such a no-op (an edge with src != dst, a task with a
    nonzero duration); depth, the most edges on a path (after that many
    rounds the relaxation is at its fixed point); and under a topology
    with M_pad <= 32 each rack's mask (:func:`pair_masks`). Refuses task
    ids outside [0, n_pad), edge
    ids past 16 bits, a repeated (src, dst) pair and an adjacency cell
    below -1e30 (the kernel's rounds leave out the -1e30 cells of absent
    edges, which is exact only above it: ``csrc/cpm.cu``)."""
    if len(tables) < 7 or not isinstance(tables[6], torch.Tensor) or tables[6].dim() != 2:
        raise ValueError("p_task must be an [I, n_pad] tensor")
    n_pad = int(tables[6].shape[1])
    tables, M_pad = _check_tables(tables, n_pad, tables[0].device)
    src, dst, p_src, c_local, c_net, net_work, p_task, chan_div = tables[:8]
    I, m_pad = (int(s) for s in src.shape)
    dev = src.device
    topo = TOPO_NONE if M_pad is None else (
        TOPO_MASKS if M_pad <= MAX_MASK_RACKS else TOPO_TABLE)
    for name, t in (("src", src), ("dst", dst)):
        if t.numel() and (int(t.min()) < 0 or int(t.max()) >= n_pad):
            raise ValueError(f"{name} holds a task id outside [0, {n_pad}): it does not pack")
    if m_pad > _U16 + 1:
        raise ValueError(f"m_pad {m_pad} does not pack: edge ids take 16 bits")
    at = lb_layout(n_pad, m_pad, M_pad or 0, topo)
    e_idx = torch.arange(m_pad, device=dev)
    v_idx = torch.arange(n_pad, device=dev)
    real = src != dst
    if m_pad:
        pair_id = torch.where(real, src * n_pad + dst, -1 - e_idx)
        srt = pair_id.sort(dim=1).values
        if bool((srt[:, 1:] == srt[:, :-1]).any()):
            raise ValueError("an instance repeats an edge (src, dst): it does not pack")
    neg = torch.tensor(ref.NEG_INF, dtype=torch.float32)
    cell_l = ref._finite(c_local + p_src)
    cell_n = ref._finite(c_net + p_src)
    low = (cell_l < neg) | (cell_n < neg)
    if topo:
        low |= (cell_n + tables[9]) < neg
    if bool((real & low).any()):
        raise ValueError("an adjacency cell lies below -1e30: it does not pack")

    indeg = torch.zeros((I, n_pad), dtype=torch.int64, device=dev)
    indeg.scatter_add_(1, dst, real.to(torch.int64))
    has_in = indeg > 0
    n_in = has_in.sum(dim=1)
    has0 = n_in < n_pad
    j_of = has_in.to(torch.int64).cumsum(dim=1) - 1
    slot = torch.where(has_in, j_of, n_in[:, None])  # a task's relaxation column
    spare = n_pad + 1  # a scratch column the scatters below drop
    col_at = torch.where(has_in, j_of, torch.full_like(j_of, spare))
    col_cnt = torch.zeros((I, n_pad + 2), dtype=torch.int64, device=dev)
    col_cnt.scatter_(1, col_at, indeg)
    col_p = torch.zeros((I, n_pad + 2), dtype=torch.float32, device=dev)
    col_p.scatter_(1, col_at, p_task)
    pmax0 = torch.where(has_in, torch.full_like(p_task, float("-inf")), p_task).amax(dim=1)
    col_p.scatter_(1, torch.where(has0, n_in, spare)[:, None], pmax0[:, None])
    # In-edge entries column after column, in edge order within a column;
    # the edges left out (src == dst) sort last.
    key = torch.where(real, slot.gather(1, dst) * m_pad + e_idx, (n_pad + 1) * m_pad + e_idx)
    order = key.argsort(dim=1)
    entry = slot.gather(1, src) | (e_idx << 16)
    listed = e_idx[None, :] < real.sum(dim=1, keepdim=True)
    col_in = torch.where(listed, entry.gather(1, order), torch.zeros_like(entry))
    m_walk = (torch.where(real, e_idx + 1, torch.zeros_like(e_idx)).amax(dim=1) if m_pad
              else torch.zeros(I, dtype=torch.int64, device=dev))
    n_loads = torch.where(p_task != 0, v_idx + 1, torch.zeros_like(v_idx)).amax(dim=1)
    # depth: the most edges on a path (Bellman rounds over levels from 0); an
    # instance whose levels still grow after n_pad rounds has a cycle and
    # gets _U16, which leaves the kernel's rounds to stop at a fixed point.
    level = torch.zeros((I, n_pad), dtype=torch.int64, device=dev)
    for _ in range(n_pad + 1):
        up = torch.where(real, level.gather(1, src) + 1, torch.zeros_like(src))
        nxt = level.scatter_reduce(1, dst, up, reduce="amax")
        if torch.equal(nxt, level):
            break
        level = nxt
    depth = level.amax(dim=1)
    depth = torch.where(depth >= n_pad, torch.full_like(depth, _U16), depth)

    blob = torch.zeros((I, at["words"]), dtype=torch.int32, device=dev)
    blob[:, 0] = (n_in + has0).to(torch.int32)
    blob[:, 1] = m_walk.to(torch.int32)
    blob[:, 2] = n_loads.to(torch.int32)
    blob[:, 3] = _bits(chan_div)
    blob[:, 4] = depth.to(torch.int32)
    rec = torch.stack([_pair(src, dst), _bits(cell_l), _bits(cell_n), _bits(net_work)], dim=2)
    blob[:, at["rec"]:at["col_cnt"]] = rec.reshape(I, 4 * m_pad)
    blob[:, at["col_cnt"]:at["col_p"]] = col_cnt[:, :n_pad + 1].to(torch.int32)
    blob[:, at["col_p"]:at["col_in"]] = _bits(col_p[:, :n_pad + 1])
    blob[:, at["col_in"]:at["p_task"]] = _word(col_in)
    blob[:, at["p_task"]:at["p_task"] + n_pad] = _bits(p_task)
    blob[:, at["c_local"]:at["c_local"] + m_pad] = _bits(c_local)
    blob[:, at["c_net"]:at["c_net"] + m_pad] = _bits(c_net)
    blob[:, at["p_src"]:at["p_src"] + m_pad] = _bits(p_src)
    if topo:
        pair_ok, uplift = tables[8], tables[9]
        blob[:, at["uplift"]:at["uplift"] + m_pad] = _bits(uplift)
        blob[:, at["pair_ok"]:at["pair_ok"] + M_pad * M_pad] = _bits(pair_ok).reshape(I, -1)
        if topo == TOPO_MASKS:
            blob[:, at["mask"]:at["mask"] + M_pad] = pair_masks(pair_ok)
    return PackedLB(blob.contiguous(), n_pad, m_pad, M_pad, topo)


def unpack_lb_tables(packed: PackedLB) -> tuple:
    """The stage-1 tables of ``_build_lb_arrays`` from their packed form
    (src, dst int64; the rest float32; pair_ok and uplift under a
    topology), equal to what was packed."""
    blob, n_pad, m_pad, M_pad = packed.blob, packed.n_pad, packed.m_pad, packed.M_pad
    at = packed.layout
    I = int(blob.shape[0])
    rec = blob[:, at["rec"]:at["col_cnt"]].reshape(I, m_pad, 4)
    src, dst = _halves(rec[..., 0])

    def floats(name, size):
        return _floats(blob[:, at[name]:at[name] + size])

    out = (src, dst, floats("p_src", m_pad), floats("c_local", m_pad), floats("c_net", m_pad),
           _floats(rec[..., 3]), floats("p_task", n_pad), _floats(blob[:, 3]))
    if packed.topo:
        out += (floats("pair_ok", M_pad * M_pad).reshape(I, M_pad, M_pad),
                floats("uplift", m_pad))
    return out


def fleet_launch_plan(B: int, packed: PackedLB, M_pad: int, device=None) -> dict:
    """The launch ``fleet_combined_lb`` makes on ``device``'s card for
    these sizes: rows a block, blocks, whether a block stages its instance
    blob, dynamic shared memory bytes and the card's SMs, with the pair
    route (``PackedLB.pair_route``)."""
    from repro_torch.kernels.build import load_cpm

    lib = load_cpm()
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = lib.cpm_fleet_plan(B, packed.n_pad, packed.m_pad, int(M_pad), packed.topo, out)
    _raise_if(err, "cpm_fleet_plan")
    plan = dict(zip(("rows_per_block", "blocks", "staged_blob", "smem_bytes", "sms"), out))
    plan["pair_route"] = packed.pair_route
    return plan


def fleet_combined_lb(
    racks: torch.Tensor,    # int16 [B, n_pad] candidate rack per task (int32 / int64 on the CPU)
    inst_id: torch.Tensor,  # int32 [B] fleet instance of each row (int64 beside int64 racks)
    *tables,                # the stage-1 tables (CPU only), or one PackedLB
    M_pad: int,
    n_iters: int | None,
    contention: bool,
) -> torch.Tensor:
    """lb[B]: the scheduler's stage-1 bound of every candidate row.

    ``tables`` is either the tables of
    ``repro_torch.core.vectorized._build_lb_arrays`` as
    :func:`repro_torch.kernels.ref.ref_fleet_lb` takes them (src, dst
    int64 [I, m_pad]; p_src, c_local, c_net, net_work f32 [I, m_pad];
    p_task f32 [I, n_pad]; chan_div f32 [I]; then optionally pair_ok f32
    [I, M_pad, M_pad] and uplift f32 [I, m_pad], which select the masked
    body), or their :class:`PackedLB`. A CUDA tensor goes to
    ``cpm_fleet_lb`` / ``cpm_fleet_lb_masked`` on the current stream of
    ``racks``' card, which take int16 racks, int32 instance ids and the
    packed tables only; a CPU tensor, with int16, int32 or int64 racks, to
    the plain version."""
    if not isinstance(racks, torch.Tensor) or racks.dim() != 2:
        raise ValueError("racks must be a [B, n_pad] tensor")
    B, n_pad = int(racks.shape[0]), int(racks.shape[1])
    if not 1 <= n_pad <= MAX_N:
        raise ValueError(f"n_pad must be in [1, {MAX_N}], got {n_pad}")
    dev = racks.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    cuda = dev.type == "cuda"
    _check("racks", racks, (B, n_pad), dev,
           (torch.int16,) if cuda else (torch.int16, torch.int32, torch.int64))
    _check("inst_id", inst_id, (B,), dev,
           (torch.int64,) if racks.dtype == torch.int64 else (torch.int32,))
    packed = tables[0] if len(tables) == 1 else None
    if packed is not None:
        if not isinstance(packed, PackedLB) or not isinstance(packed.blob, torch.Tensor):
            raise TypeError("one table argument must be a PackedLB (pack_lb_tables)")
        if packed.n_pad != n_pad:
            raise ValueError(f"packed tables of n_pad {packed.n_pad} passed with racks of "
                             f"n_pad {n_pad}")
        if packed.topo and packed.M_pad != M_pad:
            raise ValueError(f"packed tables of M_pad {packed.M_pad} passed with M_pad {M_pad}")
        _check("packed", packed.blob, (int(packed.blob.shape[0]), packed.layout["words"]), dev,
               (torch.int32,))
    else:
        if cuda:
            raise TypeError("the CUDA route reads the packed tables: pass "
                            "pack_lb_tables(*tables), made once a fleet")
        tables, pair_M = _check_tables(tables, n_pad, dev)
        if pair_M is not None and pair_M != M_pad:
            raise ValueError(f"pair_ok of M_pad {pair_M} passed with M_pad {M_pad}")
    iters = ref.clamp_iters(n_pad, n_iters)
    kw = dict(M_pad=M_pad, n_iters=iters, contention=contention)
    if not cuda:
        return ref.ref_fleet_lb(racks, inst_id, *(tables if packed is None else packed.tables),
                                **kw)
    words = fleet_state_words(n_pad, packed.m_pad)
    if 16 + 4 * words > _SMEM_MAX:
        raise ValueError(f"stage-1 row state of {words} words (n_pad {n_pad}, m_pad "
                         f"{packed.m_pad}) exceeds the kernel's shared memory")
    if racks.data_ptr() % 16 or packed.blob.data_ptr() % 16:
        raise ValueError("racks and the packed tables must start 16-byte aligned")
    from repro_torch.kernels.build import load_cpm

    lib = load_cpm()
    name = "fleet_lb_masked" if packed.topo else "fleet_lb"
    with torch.cuda.device(dev):
        out = torch.empty((B,), dtype=torch.float32, device=dev)
        err = getattr(lib, "cpm_" + name)(
            racks.data_ptr(), inst_id.data_ptr(), packed.blob.data_ptr(), out.data_ptr(),
            B, n_pad, packed.m_pad, int(M_pad), packed.topo, iters, int(bool(contention)),
            _stream(dev),
        )
    _raise_if(err, "cpm_" + name)
    launches[name] += 1
    return out
