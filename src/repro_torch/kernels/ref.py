"""Plain PyTorch versions of the port's kernels.

``ref_critical_path`` / ``ref_combined_lb`` are twins of the JAX
package's oracles, written in float32 with the kernel's own round loop,
non-finite mapping and association, so that they equal the CUDA kernel
(and the Pallas kernel) bit for bit. ``ref_fleet_lb`` is the twin of the
JAX package's stage-1 device program
(``src/repro/core/vectorized.py:_fleet_lb_device``): the adjacency and
mask scatter and the contention terms in PyTorch, then
``ref_combined_lb``; the fused kernel ``cpm_fleet_lb`` equals it bit for
bit.

``ref_fleet_evaluate`` is the scheduler's stage 2, the twin of the JAX
package's ``lax.scan`` evaluator
(``src/repro/core/vectorized.py:_scan_evaluate``): one step of gathers,
scatters and selects per op-table row; the kernel ``fleet_evaluate``
(``csrc/stage2.cu``) equals it bit for bit.

``ref_flash_attention`` / ``ref_decode_attention`` are twins of the JAX
package's attention oracles (``src/repro/kernels/ref.py``): float32
scores, masked scores at -1e30, a full softmax, the output cast to q's
type. The kernels reorder the sums (online softmax), so they agree with
these within 2e-5 in float32 and 4e-2 in bfloat16.

``ref_flash_attention(..., return_lse=True)`` also gives each row's
log-sum-exp, and ``ref_flash_attention_bwd`` is the plain version of the
three backward kernels (``csrc/flash_attention_bwd.cu``): the JAX
package's ``_flash_bwd`` (``src/repro/models/flash.py:108``) with its
rounding points, on unrepeated K and V.

``ref_decode_attention_split`` is a plain model of the decode kernel's
split and combine, for the tests only.

``ref_moe_dispatch`` is the twin of the JAX package's MoE dispatch (a
cumulative sum of a one-hot for the slots, ``.at[].add`` for the buffer):
the CPU route of ``models/moe.py``. The kernels of
``csrc/moe_dispatch.cu`` equal it with ``torch.equal``, and
``ref_moe_dispatch_grad`` is the plain version of their backward.

``ref_selective_scan`` is the plain version of Mamba-1's selective scan
(``csrc/selective_scan.cu``): a loop over time of float32 steps on the
[B, d_inner, N] state. The kernel takes its exponentials in the SFU's
approximation, so they agree within float32 round-off of the state and
the output's rounding to its type.

The CPU routes of :mod:`repro_torch.kernels.cpm`,
:mod:`repro_torch.kernels.stage2`, :mod:`repro_torch.kernels.attention`
and :mod:`repro_torch.kernels.moe_dispatch` and the tests use them;
``chip_smoke.py`` and the ``cuda`` tests hold the kernels against them on
the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "NEG_INF",
    "clamp_iters",
    "ref_critical_path",
    "ref_combined_lb",
    "ref_fleet_lb",
    "ref_fleet_operands",
    "ref_fleet_evaluate",
    "ref_flash_attention",
    "ref_flash_attention_bwd",
    "ref_flash_bwd_delta",
    "ref_flash_bwd_dkdv",
    "ref_flash_bwd_dq",
    "ref_decode_attention",
    "ref_decode_attention_split",
    "ref_moe_dispatch",
    "ref_moe_dispatch_grad",
    "ref_selective_scan",
]

NEG_INF = -1e30
# Op-table row kinds (repro_torch/core/simulator.py: OP_TASK, OP_EDGE).
OP_TASK, OP_EDGE = 0, 1


def clamp_iters(n: int, n_iters: int | None) -> int:
    """Relaxation round count: default n - 1, clamped to [0, n - 1]."""
    if n_iters is None:
        n_iters = n - 1
    return max(0, min(int(n_iters), n - 1))


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.full_like(x, NEG_INF))


def _relax(w: torch.Tensor, n_iters: int) -> torch.Tensor:
    B, n, _ = w.shape
    dist = torch.zeros((B, n), dtype=torch.float32, device=w.device)
    for _ in range(n_iters):
        # cand[b, u, v] = dist[b, u] + w[b, u, v]
        cand = dist[:, :, None] + w
        dist = torch.maximum(dist, cand.amax(dim=1))
    return dist


def ref_critical_path(w: torch.Tensor, n_iters: int | None = None) -> torch.Tensor:
    """dist[B, n] after ``n_iters`` Bellman max-plus rounds over w[B, n, n]."""
    w = _finite(w.to(torch.float32))
    return _relax(w, clamp_iters(w.shape[1], n_iters))


def ref_combined_lb(
    w: torch.Tensor,      # [B, n, n] max-plus adjacency (-inf = no edge)
    p: torch.Tensor,      # [B, n] per-row task durations (0 on padding)
    extra: torch.Tensor,  # [B] or [B, 1] contention bound (-inf to disable)
    mask: torch.Tensor | None = None,  # [B, n, n] feasibility uplift (>= 0)
    n_iters: int | None = None,
) -> torch.Tensor:
    """lb[B] = max(max_v dist[v] + p[v], extra), relaxed over ``w + mask``
    when a mask is given; all-padding rows give exactly 0."""
    w = _finite(w.to(torch.float32))
    if mask is not None:
        w = w + mask.to(torch.float32)
    dist = _relax(w, clamp_iters(w.shape[1], n_iters))
    lb = (dist + p.to(torch.float32)).amax(dim=1)
    extra = _finite(extra.to(torch.float32).reshape(-1))
    return torch.maximum(lb, extra)


def ref_fleet_operands(
    racks,      # int[B, n_pad] candidate rack per task (int32 or int64)
    inst_id,    # int[B] fleet instance of each row
    src,        # int64[I, m_pad] edge source task (0 on padding)
    dst,        # int64[I, m_pad] edge destination task (0 on padding)
    p_src,      # f32[I, m_pad] source-task duration per edge (0 on padding)
    c_local,    # f32[I, m_pad] local delay per edge (-inf on padding)
    c_net,      # f32[I, m_pad] optimistic network duration (-inf on padding)
    net_work,   # f32[I, m_pad] min network duration (0 on padding)
    p_task,     # f32[I, n_pad] task durations (0 on padding)
    chan_div,   # f32[I] 1 + |K| network channels
    pair_ok=None,  # f32[I, M_pad, M_pad] 1 = rack pair shares a reachable subchannel
    uplift=None,   # f32[I, m_pad] forced-wired uplift q - min(q, q̌)
    *,
    M_pad: int,
    contention: bool,
) -> tuple:
    """The operands ``(w, p, extra, mask)`` of ``ref_combined_lb`` for every
    candidate row, built from its racks and its instance's edge tables (see
    ``repro_torch.core.vectorized._build_lb_arrays``); ``mask`` is None
    unless ``pair_ok`` / ``uplift`` are given."""
    racks, inst_id = racks.long(), inst_id.long()
    B, n_pad = racks.shape
    m_pad = src.shape[1]
    dev = racks.device
    f32 = torch.float32

    def take(t):
        return t.index_select(0, inst_id)

    src_b, dst_b = take(src), take(dst)
    ru = racks.gather(1, src_b)
    rv = racks.gather(1, dst_b)
    same = ru == rv
    cost = torch.where(same, take(c_local), take(c_net)) + take(p_src)
    # Batched static-index scatter: padded edges all write -inf at (0, 0),
    # which no real edge can occupy (self-loops are rejected by DagJob), so
    # their duplicate indices are harmless.
    rows = torch.arange(B, device=dev)[:, None]
    w = torch.full((B, n_pad, n_pad), float("-inf"), dtype=f32, device=dev)
    w[rows, src_b, dst_b] = cost
    p_b = take(p_task)

    if pair_ok is not None:
        # Per-edge pair connectivity under each candidate's rack choice.
        ok = pair_ok[inst_id[:, None], ru, rv] > 0.5
        # Additive matching-feasibility mask: 0 on feasible edges, the wired
        # uplift on forced ones (same scatter as ``w``).
        up = torch.where(same | ok, torch.zeros((), dtype=f32, device=dev), take(uplift))
        mask = torch.zeros((B, n_pad, n_pad), dtype=f32, device=dev)
        mask[rows, src_b, dst_b] = up
    else:
        ok = None
        mask = None

    if contention:
        # §IV-A contention terms, accumulated one task / edge at a time in
        # the reference's order (never a reduction, which would reorder the
        # float32 adds), so an instance's bounds are bit-identical under any
        # fleet padding (padded tasks/edges contribute exact zeros).
        zero = torch.zeros((), dtype=f32, device=dev)
        rack_ids = torch.arange(M_pad, device=dev)
        load = torch.zeros((B, M_pad), dtype=f32, device=dev)
        for v in range(n_pad):
            hit = racks[:, v, None] == rack_ids
            load = load + torch.where(hit, p_b[:, v, None], zero)
        lb_load = load.amax(dim=1)

        nw = take(net_work)
        if ok is None:
            work = torch.zeros((B,), dtype=f32, device=dev)
            for e in range(m_pad):
                work = work + torch.where(same[:, e], zero, nw[:, e])
            extra = torch.maximum(lb_load, work / take(chan_div))
        else:
            # Forced cross edges pay the full wired duration in the
            # aggregate-work term and, being confined to the single wired
            # channel, also a serial forced-wired load bound.
            nw_eff = nw + torch.where(ok, zero, take(uplift))
            work = torch.zeros((B,), dtype=f32, device=dev)
            forced = torch.zeros((B,), dtype=f32, device=dev)
            for e in range(m_pad):
                se, ne = same[:, e], nw_eff[:, e]
                work = work + torch.where(se, zero, ne)
                forced = forced + torch.where(se | ok[:, e], zero, ne)
            extra = torch.maximum(
                torch.maximum(lb_load, work / take(chan_div)), forced
            )
    else:
        extra = torch.full((B,), float("-inf"), dtype=f32, device=dev)
    return w, p_b, extra, mask


def ref_fleet_lb(
    racks, inst_id, *tables, M_pad: int, n_iters: int, contention: bool
) -> torch.Tensor:
    """lb[B]: the combined §IV-A bound of every candidate row (``tables`` as
    in :func:`ref_fleet_operands`), relaxed over the feasibility mask when
    ``pair_ok`` / ``uplift`` are given."""
    w, p, extra, mask = ref_fleet_operands(
        racks, inst_id, *tables, M_pad=M_pad, contention=contention
    )
    return ref_combined_lb(w, p, extra, mask=mask, n_iters=n_iters)


def ref_fleet_evaluate(
    rack,       # int[B, n_pad]    candidate assignments (one job's tasks per row)
    inst_id,    # int[B]           which fleet instance each row belongs to
    kind,       # int64[I, n_ops]  OP_TASK / OP_EDGE / OP_PAD
    op_task,    # int64[I, n_ops]  task id for OP_TASK rows (0 otherwise)
    op_edge,    # int64[I, n_ops]  edge id for OP_EDGE rows (0 otherwise)
    op_src,     # int64[I, n_ops]  edge source task (0 otherwise)
    op_dst,     # int64[I, n_ops]  edge dest task (0 otherwise)
    op_p,       # f32[I, n_ops]    task duration
    op_wired,   # f32[I, n_ops]    wired transfer duration
    op_wireless,  # f32[I, n_ops]  wireless transfer duration
    op_local,   # f32[I, n_ops]    local transfer delay
    op_in,      # int64[I, n_ops, indeg_pad] in-edge ids gating a task row;
                #                  the sentinel id m_pad always reads 0.0
    chan_free0,  # f32[I, n_chan]  initial channel availability: 0 = usable,
                #                  +inf = masked (instance has fewer channels)
    reach,      # f32[I, M_pad, n_chan] topology reachability: 1 = rack may
                #                  use the channel (col 0, wired, always 1);
                #                  all-ones when the instance has no topology
    *,
    m_pad: int,
    M_pad: int,
    n_chan: int,
) -> torch.Tensor:
    """makespan[B]: the greedy non-delay schedule of every row, one step
    per op-table row. Each step reads only the pre-step state, exactly as
    the reference's ``lax.scan`` body; the writes are in-place gathers and
    scatters of one element per row (rows whose op kind does not match
    write their old value back)."""
    rack, inst_id = rack.long(), inst_id.long()
    B, n_pad = rack.shape
    n_ops = kind.shape[1]
    rows = torch.arange(B, device=rack.device)

    def take(t):
        # Per-row tables, op axis leading so each step reads a contiguous row.
        return t.index_select(0, inst_id).transpose(0, 1).contiguous()

    kind_s, task_s, edge_s = take(kind), take(op_task), take(op_edge)
    src_s, dst_s = take(op_src), take(op_dst)
    p_s, qw_s, qwl_s, rl_s = take(op_p), take(op_wired), take(op_wireless), take(op_local)
    in_s = take(op_in)                                   # [n_ops, B, indeg_pad]
    reach_b = reach.index_select(0, inst_id)             # [B, M_pad, n_chan]

    rack_free = torch.zeros((B, M_pad), dtype=torch.float32, device=rack.device)
    chan_free = chan_free0.index_select(0, inst_id)      # +inf = masked
    task_fin = torch.zeros((B, n_pad), dtype=torch.float32, device=rack.device)
    edge_fin = torch.zeros((B, m_pad + 1), dtype=torch.float32, device=rack.device)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=rack.device)

    for t in range(n_ops):
        is_task = kind_s[t] == OP_TASK
        is_edge = kind_s[t] == OP_EDGE
        t_v, e_id, u, v = task_s[t], edge_s[t], src_s[t], dst_s[t]

        # Task branch: start when all gating in-edges have finished and the
        # task's rack is free.
        ready_t = edge_fin.gather(1, in_s[t]).amax(dim=1)
        rv = rack[rows, t_v]
        rack_old = rack_free[rows, rv]
        fin_t = torch.maximum(ready_t, rack_old) + p_s[t]

        # Edge branch: local delay when co-located, else the earliest-finish
        # channel (0 wired, 1.. wireless); masked and topology-infeasible
        # channels sit at +inf and are never selected. argmin takes the
        # lowest index on ties, as jnp.argmin does.
        ready_e = task_fin[rows, u]
        ra, rb = rack[rows, u], rack[rows, v]
        same = ra == rb
        fin_local = ready_e + rl_s[t]
        durs = torch.cat(
            [qw_s[t][:, None], qwl_s[t][:, None].expand(B, n_chan - 1)], dim=1
        )
        s = torch.maximum(ready_e[:, None], chan_free)
        feas = reach_b[rows, ra] * reach_b[rows, rb]
        f = torch.where(feas > 0, s + durs, inf)
        best = f.argmin(dim=1)
        fin_net = f[rows, best]
        fin_e = torch.where(same, fin_local, fin_net)

        # Merge by per-row op kind (OP_PAD rows change nothing).
        chan_old = chan_free[rows, best]
        task_old = task_fin[rows, t_v]
        edge_old = edge_fin[rows, e_id]
        rack_free[rows, rv] = torch.where(is_task, fin_t, rack_old)
        task_fin[rows, t_v] = torch.where(is_task, fin_t, task_old)
        chan_free[rows, best] = torch.where(is_edge & ~same, fin_net, chan_old)
        edge_fin[rows, e_id] = torch.where(is_edge, fin_e, edge_old)
    return task_fin.amax(dim=1)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """float32 scores [B, S, KV, G, T] of the folded query heads, scaled,
    with keys t > s at -1e30 when causal."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, D).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bskgt", qg, k.to(torch.float32)) / math.sqrt(D)
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(
            T, device=q.device
        )[None, :]
        s = torch.where(mask[None, :, None, None, :], s, s.new_tensor(NEG_INF))
    return s


def ref_flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    causal: bool = True,
    return_lse: bool = False,
):
    """GQA attention, query s attending to keys t <= s when causal; with
    ``return_lse`` also each row's log-sum-exp [B, S, H] in float32 (the
    scaled scores' natural logsumexp, the forward residual of
    ``models/flash.py:85-87`` of the JAX package)."""
    B, S, H, D = q.shape
    s = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgt,btkd->bskgd", p, v.to(torch.float32))
    o = o.reshape(B, S, H, D).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, S, H)
    return o


def ref_flash_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta [B, S, H] float32 = rowsum(do * o) (``models/flash.py:119-122``)."""
    return (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)


def _bwd_scores(q, k, v, do, lse, delta, causal):
    """(p, ds rounded to q's type, as float32), both [B, S, KV, G, T]: p =
    exp(s - lse), ds = p * (do . v - delta) * scale."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    f32 = torch.float32
    dog = do.reshape(B, S, KV, G, D).to(f32)
    p = torch.exp(_scores(q, k, causal) - lse.reshape(B, S, KV, G)[..., None])
    dp = torch.einsum("bskgd,btkd->bskgt", dog, v.to(f32))
    ds = p * (dp - delta.reshape(B, S, KV, G)[..., None]) * (1.0 / math.sqrt(D))
    return p, ds.to(q.dtype).to(f32)


def ref_flash_bwd_dkdv(q, k, v, do, lse, delta, causal: bool = True):
    """(dk, dv) [B, T, KV, D] in k's and v's types: p rounded to v's type
    for dv, ds to q's type for dk, the G query heads of each kv head
    summed."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    f32 = torch.float32
    p, ds = _bwd_scores(q, k, v, do, lse, delta, causal)
    dog = do.reshape(B, S, KV, H // KV, D).to(f32)
    dv = torch.einsum("bskgt,bskgd->btkd", p.to(v.dtype).to(f32), dog)
    dk = torch.einsum("bskgt,bskgd->btkd", ds, q.reshape(B, S, KV, H // KV, D).to(f32))
    return dk.to(k.dtype), dv.to(v.dtype)


def ref_flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True) -> torch.Tensor:
    """dq [B, S, H, D] in q's type: ds rounded to q's type, times k."""
    B, S, H, D = q.shape
    _, ds = _bwd_scores(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bskgt,btkd->bskgd", ds, k.to(torch.float32))
    return dq.reshape(B, S, H, D).to(q.dtype)


def ref_flash_attention_bwd(
    q: torch.Tensor,    # [B, S, H, D]
    k: torch.Tensor,    # [B, T, KV, D]
    v: torch.Tensor,    # [B, T, KV, D]
    o: torch.Tensor,    # [B, S, H, D] forward output
    lse: torch.Tensor,  # [B, S, H] float32 forward log-sum-exp
    do: torch.Tensor,   # [B, S, H, D] output gradient
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of GQA attention, as ``_flash_bwd`` of the JAX package
    (``models/flash.py:108``) computes them: p = exp(s - lse), delta =
    rowsum(do * o), ds = p * (do . v - delta) * scale in float32; p
    rounded to v's type for dv, ds to q's type for dq and dk (its ``pv``
    and ``dsv``); the G query heads of a kv head summed into its dk, dv;
    each result in its input's type. The plain versions of the three
    backward kernels in turn."""
    delta = ref_flash_bwd_delta(o, do)
    dk, dv = ref_flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
    return ref_flash_bwd_dq(q, k, v, do, lse, delta, causal), dk, dv


def ref_decode_attention(
    q: torch.Tensor,       # [B, H, D]
    k: torch.Tensor,       # [B, T, KV, D]
    v: torch.Tensor,       # [B, T, KV, D]
    kv_len: torch.Tensor,  # [] or [B] valid cache length
) -> torch.Tensor:
    """One query token per row over the first ``kv_len[b]`` cache rows."""
    B, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, D).to(torch.float32)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.to(torch.float32)) / math.sqrt(D)
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device)
    valid = torch.arange(T, device=q.device)[None, :] < kv_len.reshape(-1, 1)
    s = torch.where(valid[:, None, None, :], s, s.new_tensor(NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.to(torch.float32))
    return o.reshape(B, H, D).to(q.dtype)


def ref_decode_attention_split(
    q: torch.Tensor,  # [B, H, D]
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    kv_len,           # int, [] or [B] valid cache length
    n_splits: int,
) -> torch.Tensor:
    """The decode kernel's plan in plain PyTorch: split s of row b covers
    rows ``[s * n_b // S, (s + 1) * n_b // S)`` with ``n_b = min(kv_len[b],
    T)`` (all T rows, each masked at -1e30, when kv_len[b] <= 0); each split
    gives its max m, sum l and accumulator in float32 (an empty one m =
    -1e30, l = 0, acc = 0), and the splits are combined with weights
    exp(m_s - max m)."""
    B, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    S = int(n_splits)
    qg = q.reshape(B, KV, H // KV, D).to(torch.float32) / math.sqrt(D)
    lens = torch.as_tensor(kv_len).reshape(-1).expand(B).tolist()
    out = torch.empty(qg.shape, dtype=torch.float32, device=q.device)
    for b, n in enumerate(lens):
        none = n <= 0
        n = T if none else min(n, T)
        ms, ls, accs = [], [], []
        for s in range(S):
            lo, hi = s * n // S, (s + 1) * n // S
            if hi == lo:
                ms.append(qg.new_full(qg.shape[1:3], NEG_INF))
                ls.append(qg.new_zeros(qg.shape[1:3]))
                accs.append(qg.new_zeros(qg.shape[1:]))
                continue
            kb = k[b, lo:hi].to(torch.float32)
            sc = torch.einsum("kgd,tkd->kgt", qg[b], kb)
            if none:
                sc = torch.full_like(sc, NEG_INF)
            m = sc.amax(dim=-1)
            p = torch.exp(sc - m[..., None])
            ms.append(m)
            ls.append(p.sum(dim=-1))
            accs.append(torch.einsum("kgt,tkd->kgd", p, v[b, lo:hi].to(torch.float32)))
        m = torch.stack(ms)  # [S, KV, G]
        w = torch.exp(m - m.amax(dim=0))
        num = (w[..., None] * torch.stack(accs)).sum(dim=0)
        den = (w * torch.stack(ls)).sum(dim=0)
        out[b] = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def ref_moe_dispatch(src: torch.Tensor, expert_idx: torch.Tensor, n_experts: int, cap: int,
                     offset: torch.Tensor | None = None, first: int = 0,
                     n_local: int | None = None):
    """(experts [TK], slots [TK], keep [TK], buffer [n_local, C, d], mine
    [TK]) of the TK (token, choice) pairs of ``expert_idx`` [T, k], the
    twin of the JAX package's dispatch (``src/repro/models/moe.py:72-84``).
    Pair p = t * k + j reads row ``p // (TK // rows)`` of ``src`` [rows, d]:
    its token's row of [T, d], or its own of [TK, d].

    Each pair's slot is its rank among the pairs routed to its expert in
    row-major order (a cumulative sum of the one-hot), plus ``offset[e]``
    (the pairs of earlier rows held elsewhere); ``keep`` drops the pairs at
    or over ``cap``, whose slot becomes 0. The kept pairs routed to experts
    ``first`` .. ``first + n_local - 1`` (all by default; ``mine``) are
    scattered into a buffer of those experts, ``experts`` being each pair's
    index there (0 for a pair of another expert); every other pair adds
    zeros (a dropped pair into slot 0 of its expert, as ``.at[].add``
    does)."""
    TK = expert_idx.numel()
    d = src.shape[-1]
    n_local = n_local or n_experts
    pairs = src
    if src.shape[0] != TK:
        pairs = src[torch.arange(TK, device=src.device) // (TK // src.shape[0])]
    flat_expert = expert_idx.reshape(TK)  # row-major: pair p = t*k + j
    onehot = F.one_hot(flat_expert, n_experts)  # [TK, E]
    pos_all = onehot.cumsum(dim=0) - 1
    if offset is not None:
        pos_all = pos_all + offset
    pos = pos_all.gather(1, flat_expert[:, None])[:, 0]
    keep = pos < cap
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))

    experts, mine = flat_expert, keep
    if n_local != n_experts:
        ours = (flat_expert >= first) & (flat_expert < first + n_local)
        experts = torch.where(ours, flat_expert - first, torch.zeros_like(flat_expert))
        mine = keep & ours
    gathered = torch.where(mine[:, None], pairs, torch.zeros((), dtype=pairs.dtype,
                                                             device=pairs.device))
    expert_in = torch.zeros((n_local, cap, d), dtype=pairs.dtype, device=pairs.device)
    expert_in.index_put_((experts, pos_c), gathered, accumulate=True)
    return experts, pos_c, keep, expert_in, mine


def ref_moe_dispatch_grad(grad: torch.Tensor, experts: torch.Tensor, slots: torch.Tensor,
                          mine: torch.Tensor, rows: int) -> torch.Tensor:
    """The gradient [rows, d] of :func:`ref_moe_dispatch`'s source rows from
    its buffer's ``grad`` [n_local, C, d]: each row's sum over its TK / rows
    pairs, in ascending choice order in float32 and rounded once to
    ``grad``'s type, of ``grad`` at each ``mine`` pair's slot (the kernel
    ``moe_dispatch_grad``'s order)."""
    per = experts.numel() // rows
    g = torch.where(mine[:, None], grad[experts, slots], torch.zeros(
        (), dtype=grad.dtype, device=grad.device)).to(torch.float32)
    g = g.reshape(rows, per, grad.shape[-1])
    acc = g[:, 0]
    for j in range(1, per):
        acc = acc + g[:, j]
    return acc.to(grad.dtype).contiguous()


def ref_selective_scan(x: torch.Tensor, dt: torch.Tensor, z: torch.Tensor, Bm: torch.Tensor,
                       Cm: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                       dt_bias: torch.Tensor) -> torch.Tensor:
    """Mamba-1's selective scan from a zero state, gated, in float32:
    x, dt, z [B, S, d_inner] (the conv output, dt before its bias and
    softplus, the gate), Bm, Cm [B, S, N], A_log [d_inner, N], D and
    dt_bias [d_inner]. With delta = softplus(dt + dt_bias) and A =
    -exp(A_log), each step t takes s = exp(delta_t A) s + (delta_t x_t) B_t
    and gives y_t = s C_t + D x_t; returns y * silu(z) in x's type."""
    A = -torch.exp(A_log.to(torch.float32))
    delta = F.softplus(dt.to(torch.float32) + dt_bias.to(torch.float32))
    xf = x.to(torch.float32)
    Bf, Cf = Bm.to(torch.float32), Cm.to(torch.float32)
    s = torch.zeros(x.shape[0], x.shape[2], A.shape[1], dtype=torch.float32, device=x.device)
    ys = []
    for t in range(x.shape[1]):
        dlt = delta[:, t, :, None]
        s = torch.exp(dlt * A) * s + (dlt * xf[:, t, :, None]) * Bf[:, t, None, :]
        ys.append((s * Cf[:, t, None, :]).sum(dim=-1))
    y = torch.stack(ys, dim=1) + D.to(torch.float32) * xf
    return (y * F.silu(z.to(torch.float32))).to(x.dtype)
