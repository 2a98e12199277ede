"""Mixture-of-Experts FFN with capacity-based scatter dispatch
(counterpart of ``repro.models.moe``).

Tokens are routed top-k on the float32 softmax, then dispatched into a
dense [E, C, d] expert buffer by a scatter; the expert SwiGLU runs as
batched products over E; over-capacity pairs are dropped, and the
Switch-style auxiliary loss keeps routing near-uniform.

Three points follow the JAX package exactly, because the dropped pairs
depend on them:

  * ties between equal probabilities go to the lower expert index, as
    ``jax.lax.top_k`` breaks them (``torch.topk`` promises no order on
    ties): the top k are the first k of a stable descending sort;
  * the capacity is ``max(ceil(T * k / E * cf), k)`` in the reference's
    float order (``moe.py:68-69``);
  * a pair's slot is its rank among the pairs routed to its expert, in
    the row-major (token, choice) order of a cumulative sum (``:72-76``).

The dispatch (:func:`_dispatch`) has two routes with the same values. On
the CPU it is the plain twin of the JAX package's cumulative sum and
``.at[].add``, where a dropped pair adds zeros into slot 0 of its expert
(``:83-84``; :func:`repro_torch.kernels.ref.ref_moe_dispatch`). On a card
it is two hand-written launches (:mod:`repro_torch.kernels.moe_dispatch`):
a row-major rank of each pair, then one writer a cell of the buffer, which
copies its pair's row or writes zeros. Both read each pair's row in place
from the token rows.

The JAX package's ``shard`` hooks stand at its lines: the expert buffer
and the expert FFN's hidden state are placed over 'model' under a mesh
(``act_expert``, ``act_expert_ffn``) and left as they are on plain
tensors.

Under a mesh (``x`` a DTensor) the routing, the scatter and the combine
run on each rank's local rows, and only the expert FFN runs on DTensors
(:func:`_sharded_moe`). DTensor's own strategies for them fail: the
scatter's ``index_put_`` into a buffer that is a DTensor trips an
assertion in DTensor's dispatch (torch 2.13), and torch 2.11's
``index_put`` strategy fails on a split operand (``layers._sharded_embed``).
Written out, every pair keeps the slot the reference's global cumulative
sum gives it, so the same pairs are dropped as the capacity binds: each
rank offsets its own cumulative sum by the counts of the ranks that hold
earlier rows of the batch. A rank holds only its own experts' part of the
buffer and of the expert output, [E/m, C, d] for experts split over m
ranks of 'model': it scatters the pairs routed to its experts, and the
pairs' output rows are summed over 'model' before the gated sum.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial

from repro_torch.distribution.sharding import shard_index
from repro_torch.kernels import moe_dispatch, ref
from repro_torch.models.layers import (
    _normal,
    init_linear,
    local_placements,
    row_placements,
    rule_placements,
    shard,
    to_local,
)
from repro_torch.obs.trace import current

Params = dict[str, Any]

# Spans and counters on the current tracer (repro_torch.obs.trace.current).
ROUTE = "moe.route"
AUX = "moe.aux"
DISPATCH = "moe.dispatch"
EXPERTS = "moe.experts"
COMBINE = "moe.combine"
DROPPED_PAIRS = "moe.dropped_pairs"  # (token, choice) pairs over the capacity: device
PAIRS = "moe.pairs"  # every (token, choice) pair: host
KERNEL_DISPATCHES = "moe.kernel_dispatches"  # dispatches through the CUDA kernels: host

__all__ = ["init_moe", "moe_ffn", "route_top_k", "capacity"]


def init_moe(
    gen: torch.Generator, d_model: int, d_ff: int, n_experts: int, dtype=torch.float32
) -> Params:
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    return {
        "router": init_linear(gen, d_model, n_experts, scale=0.02, dtype=dtype),
        "wi": _normal(gen, (n_experts, d_model, d_ff), s_in, dtype),
        "wg": _normal(gen, (n_experts, d_model, d_ff), s_in, dtype),
        "wo": _normal(gen, (n_experts, d_ff, d_model), s_out, dtype),
    }


def route_top_k(probs: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``top_k`` largest entries of each row,
    largest first, equal values in ascending index order (``jax.lax.top_k``'s
    order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :top_k], idx[..., :top_k]


def capacity(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert: ``max(ceil(T * k / E * cf), k)`` (``moe.py:68-69``)."""
    return max(int(math.ceil(n_tokens * top_k / n_experts * capacity_factor)), top_k)


def _route(xf: torch.Tensor, w: torch.Tensor, top_k: int, normalize: bool):
    """(probs [T, E] f32, gates [T, k], experts [T, k]) of tokens ``xf``."""
    logits = (xf @ w.to(xf.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    gate_vals, expert_idx = route_top_k(probs, top_k)  # [T, k]
    if normalize:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, expert_idx


def _pair_rows(xf: torch.Tensor, top_k: int) -> torch.Tensor:
    """Each (token, choice) pair's token row [TK, d], row-major."""
    token_of_pair = torch.arange(xf.shape[0] * top_k, device=xf.device) // top_k
    return xf[token_of_pair]


def _dispatch(src: torch.Tensor, expert_idx: torch.Tensor, n_experts: int, cap: int,
              offset: torch.Tensor | None = None, first: int = 0, n_local: int | None = None):
    """(experts [TK], slots [TK], keep [TK], buffer [n_local, C, d], mine
    [TK]) of the (token, choice) pairs of ``expert_idx`` [T, k], pair p
    reading row ``p // (TK // rows)`` of ``src``: token rows [T, d], or a
    row a pair [TK, d] (:func:`repro_torch.kernels.ref.ref_moe_dispatch`
    says what each output is). The device picks the route: a CPU tensor
    takes the plain twin of the JAX package's dispatch, a CUDA one the
    hand-written rank and gather (which refuse what they cannot take),
    counted on the current tracer (``KERNEL_DISPATCHES``, forward only).
    Both give the same values."""
    if not src.is_cuda:
        return ref.ref_moe_dispatch(src, expert_idx, n_experts, cap, offset, first, n_local)
    tr = current()
    if tr.enabled and torch._C._current_autograd_node() is None:
        tr.count(KERNEL_DISPATCHES, 1)
    return moe_dispatch.moe_dispatch(src, expert_idx, n_experts, cap, offset, first, n_local)


def _experts(params: Params, expert_in: torch.Tensor, dtype) -> torch.Tensor:
    """The batched expert SwiGLU over [E, C, d]; under a mesh the weights
    are placed as the buffer is (experts over 'model', rows gathered)."""
    wi, wg, wo = (params[k].to(dtype) for k in ("wi", "wg", "wo"))
    if isinstance(expert_in, DTensor):
        mesh, pl = expert_in.device_mesh, expert_in.placements
        wi, wg, wo = (w.redistribute(mesh, pl) for w in (wi, wg, wo))
    h = F.silu(torch.bmm(expert_in, wg)) * torch.bmm(expert_in, wi)
    h = shard(h, "act_expert_ffn")
    return torch.bmm(h, wo)  # [E, C, d]


def _gated_sum(out_pairs: torch.Tensor, keep: torch.Tensor, gate_vals: torch.Tensor,
               T: int, d: int) -> torch.Tensor:
    """Each token's gated sum [T, d] of its kept pairs' expert outputs
    ``out_pairs`` [TK, d]."""
    top_k = gate_vals.shape[-1]
    dt = out_pairs.dtype
    out_pairs = out_pairs * (gate_vals.reshape(T * top_k, 1).to(dt) * keep[:, None].to(dt))
    return out_pairs.reshape(T, top_k, d).sum(dim=1)


def moe_ffn(
    params: Params,
    x: torch.Tensor,  # [B, S, d]
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    normalize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, S, d], aux load-balance loss scalar).

    With a tracer on, the current tracer counts the pairs dropped at the
    capacity (``DROPPED_PAIRS``, a device sum) and all pairs (``PAIRS``),
    in the forward pass only: not again in the backward's recompute."""
    if isinstance(x, DTensor):
        return _sharded_moe(params, x, n_experts, top_k, capacity_factor, normalize)
    tr = current()
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    with tr.span(ROUTE):
        probs, gate_vals, expert_idx = _route(xf, params["router"]["w"], top_k, normalize)

    with tr.span(AUX):  # auxiliary load-balancing loss (Switch-style)
        me = probs.mean(dim=0)  # [E]
        ce = F.one_hot(expert_idx, n_experts).to(torch.float32).sum(dim=1).mean(dim=0)
        aux = n_experts * (me * ce).sum()

    cap = capacity(T, top_k, n_experts, capacity_factor)
    with tr.span(DISPATCH):
        flat_expert, pos_c, keep, expert_in, _ = _dispatch(xf, expert_idx, n_experts, cap)
    if tr.enabled and torch._C._current_autograd_node() is None:
        tr.count(DROPPED_PAIRS, (~keep).sum())
        tr.count(PAIRS, T * top_k)
    expert_in = shard(expert_in, "act_expert")
    with tr.span(EXPERTS):
        expert_out = _experts(params, expert_in, x.dtype)
    with tr.span(COMBINE):
        out = _gated_sum(expert_out[flat_expert, pos_c], keep, gate_vals, T, d)
    return out.reshape(B, S, d), aux


def _sharded_moe(params: Params, x: DTensor, n_experts: int, top_k: int,
                 capacity_factor: float, normalize: bool) -> tuple[DTensor, DTensor]:
    """:func:`moe_ffn` of a DTensor ``x``, the reference's slots and drops,
    each rank holding only its own experts' part of the expert buffer.

    Each rank routes its own rows (the batch split of ``x``; ranks that
    share rows repeat the same work) with the router gathered; the aux
    loss's means are sums over the batch's shards divided by the global
    token count. The rank's pairs take their global slots: its cumulative
    sum offset by the per-expert counts of the shards of earlier rows (an
    all-gather of [E] integers), so ``keep`` drops exactly the
    reference's pairs.

    ``act_expert`` places the experts over 'model' (m ranks). A rank
    scatters only its pairs whose expert lies in its own 'model' shard,
    into a local [E/m, C, d] buffer; slots are disjoint across the
    batch's shards, so the sum of those buffers over the mesh dims that
    split the batch is exact (each slot holds one pair's row and zeros).
    The expert FFN runs on that DTensor. A rank then takes its pairs'
    output rows [TK, d] from its own experts, zeros for the pairs of other
    experts, and the rows are summed over 'model' among the ranks that
    share them (again one row and zeros). The gate product and the sum
    over k run in the reference's order, so every value equals the full
    buffer's. The pairs' input rows pass through an identity whose
    backward sums their gradients over 'model' the same way, before the
    sum over each token's k pairs. The local parts declare their
    gradients (:func:`repro_torch.models.layers.local_placements`).

    It opens the one-device route's spans, but counts no pairs: ranks that
    share rows route and dispatch the same pairs, so their sums would
    count a pair once for each of them."""
    tr = current()
    mesh = x.device_mesh
    B, S, d = x.shape
    T = B * S
    rows = row_placements(x)
    full, part = local_placements(rows)
    xl = to_local(x, rows)
    Bl = xl.shape[0]
    xf = xl.reshape(Bl * S, d)
    with tr.span(ROUTE):
        probs, gate_vals, expert_idx = _route(xf, to_local(params["router"]["w"], full, part),
                                              top_k, normalize)
    with tr.span(AUX):
        me = DTensor.from_local(probs.sum(dim=0), mesh, part, run_check=False) / T
        ce = DTensor.from_local(
            F.one_hot(expert_idx, n_experts).to(torch.float32).sum(dim=(0, 1)),
            mesh, part, run_check=False) / T
        aux = n_experts * (me * ce).sum()

    cap = capacity(T, top_k, n_experts, capacity_factor)
    with tr.span(DISPATCH):
        counts = F.one_hot(expert_idx.reshape(-1), n_experts).sum(dim=0)
        offset = None
        if any(p.is_shard(0) for p in rows):
            every = DTensor.from_local(counts[None], mesh, rows, run_check=False).full_tensor()
            offset = every[:shard_index(mesh, rows, 0)].sum(dim=0)
        split = _expert_split(mesh, rows, (n_experts, cap, d))
        placed, grads = local_placements(rows, split)
        n_local = n_experts // math.prod(mesh.size(i) for i in split)
        pairs = _grad_summed(_pair_rows(xf, top_k), mesh, rows, split)
        experts, pos_c, keep, buf, mine = _dispatch(
            pairs, expert_idx, n_experts, cap, offset, shard_index(mesh, placed, 0) * n_local,
            n_local)
        expert_in = DTensor.from_local(buf, mesh, grads, run_check=False).redistribute(
            mesh, placed)
    expert_in = shard(expert_in, "act_expert")
    with tr.span(EXPERTS):
        expert_out = to_local(_experts(params, expert_in, x.dtype), placed, grads)
    with tr.span(COMBINE):
        out_pairs = expert_out[experts, pos_c]
        if split:
            out_pairs = _summed(torch.where(mine[:, None], out_pairs, torch.zeros(
                (), dtype=out_pairs.dtype, device=out_pairs.device)), mesh, rows, split)
        out = _gated_sum(out_pairs, keep, gate_vals, Bl * S, d)
    return DTensor.from_local(out.reshape(Bl, S, d), mesh, rows, run_check=False), aux


def _expert_split(mesh, rows: list, shape: tuple) -> dict[int, int]:
    """The mesh dims of more than one rank over which ``act_expert`` splits
    the experts (dim 0 of the [E, C, d] buffer), as ``{mesh dim: 0}``;
    none without a rule. A mesh dim that also splits the batch is left
    out: its ranks hold different rows, so each keeps every expert's part
    of the buffer, which ``shard`` then splits as before."""
    pl = rule_placements("act_expert", shape) or ()
    return {i: 0 for i, p in enumerate(pl)
            if p.is_shard(0) and mesh.size(i) > 1 and not rows[i].is_shard(0)}


def _grad_summed(t: torch.Tensor, mesh, rows: list, split: dict) -> torch.Tensor:
    """``t`` (rows placed as ``rows``), whose gradient is summed over the
    mesh dims of ``split``: each of those ranks holds a part of it."""
    if not split:
        return t
    grad = [Partial() if i in split else p for i, p in enumerate(rows)]
    return DTensor.from_local(t, mesh, rows, run_check=False).to_local(grad_placements=grad)


def _summed(t: torch.Tensor, mesh, rows: list, split: dict) -> torch.Tensor:
    """The sum of ``t`` over the mesh dims of ``split`` (rows placed as
    ``rows``); every rank gets the whole gradient."""
    pl = [Partial() if i in split else p for i, p in enumerate(rows)]
    return DTensor.from_local(t, mesh, pl, run_check=False).redistribute(mesh, rows).to_local()
