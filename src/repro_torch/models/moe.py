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
    the row-major (token, choice) order of a cumulative sum (``:72-76``);
    a dropped pair adds zeros into slot 0 of its expert, as ``.at[].add``
    does (``:83-84``).

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
earlier rows of the batch.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distribution.sharding import shard_index
from repro_torch.models.layers import (
    _normal,
    init_linear,
    local_placements,
    row_placements,
    shard,
    to_local,
)

Params = dict[str, Any]

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


def _dispatch(xf: torch.Tensor, expert_idx: torch.Tensor, n_experts: int, cap: int,
              offset: torch.Tensor | None = None):
    """(flat experts [TK], slots [TK], keep [TK], buffer [E, C, d]): each
    (token, choice) pair's slot is its rank among the pairs routed to its
    expert in row-major order, plus ``offset[e]`` (the pairs of earlier rows
    held elsewhere); pairs at or over ``cap`` are dropped and add zeros into
    slot 0."""
    T, d = xf.shape
    top_k = expert_idx.shape[-1]
    flat_expert = expert_idx.reshape(T * top_k)  # row-major: pair p = t*k + j
    onehot = F.one_hot(flat_expert, n_experts)  # [TK, E]
    pos_all = onehot.cumsum(dim=0) - 1
    if offset is not None:
        pos_all = pos_all + offset
    pos = pos_all.gather(1, flat_expert[:, None])[:, 0]
    keep = pos < cap
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))

    token_of_pair = torch.arange(T * top_k, device=xf.device) // top_k
    gathered = torch.where(keep[:, None], xf[token_of_pair], torch.zeros((), dtype=xf.dtype,
                                                                         device=xf.device))
    expert_in = torch.zeros((n_experts, cap, d), dtype=xf.dtype, device=xf.device)
    expert_in.index_put_((flat_expert, pos_c), gathered, accumulate=True)
    return flat_expert, pos_c, keep, expert_in


def _experts(params: Params, expert_in: torch.Tensor, dtype) -> torch.Tensor:
    """The batched expert SwiGLU over [E, C, d]; under a mesh the weights
    are placed as the buffer is (experts over 'model', rows gathered)."""
    wi, wg, wo = (params[k].to(dtype) for k in ("wi", "wg", "wo"))
    if isinstance(expert_in, DTensor):
        # Without an act_expert rule the buffer is still a Partial sum.
        mesh = expert_in.device_mesh
        pl = [Replicate() if p.is_partial() else p for p in expert_in.placements]
        expert_in = expert_in.redistribute(mesh, pl)
        wi, wg, wo = (w.redistribute(mesh, pl) for w in (wi, wg, wo))
    h = F.silu(torch.bmm(expert_in, wg)) * torch.bmm(expert_in, wi)
    h = shard(h, "act_expert_ffn")
    return torch.bmm(h, wo)  # [E, C, d]


def _combine(expert_out, flat_expert, pos_c, keep, gate_vals, T: int, d: int):
    """Each token's gated sum of its kept pairs' expert outputs [T, d]."""
    top_k = gate_vals.shape[-1]
    out_pairs = expert_out[flat_expert, pos_c]  # [TK, d]
    dt = expert_out.dtype
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
    """Returns (output [B, S, d], aux load-balance loss scalar)."""
    if isinstance(x, DTensor):
        return _sharded_moe(params, x, n_experts, top_k, capacity_factor, normalize)
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    probs, gate_vals, expert_idx = _route(xf, params["router"]["w"], top_k, normalize)

    # Auxiliary load-balancing loss (Switch-style).
    me = probs.mean(dim=0)  # [E]
    ce = F.one_hot(expert_idx, n_experts).to(torch.float32).sum(dim=1).mean(dim=0)
    aux = n_experts * (me * ce).sum()

    cap = capacity(T, top_k, n_experts, capacity_factor)
    flat_expert, pos_c, keep, expert_in = _dispatch(xf, expert_idx, n_experts, cap)
    expert_in = shard(expert_in, "act_expert")
    expert_out = _experts(params, expert_in, x.dtype)
    out = _combine(expert_out, flat_expert, pos_c, keep, gate_vals, T, d)
    return out.reshape(B, S, d), aux


def _sharded_moe(params: Params, x: DTensor, n_experts: int, top_k: int,
                 capacity_factor: float, normalize: bool) -> tuple[DTensor, DTensor]:
    """:func:`moe_ffn` of a DTensor ``x``, the reference's slots and drops.

    Each rank routes its own rows (the batch split of ``x``; ranks that
    share rows repeat the same work) with the router gathered; the aux
    loss's means are sums over the batch's shards divided by the global
    token count. The rank's pairs take their global slots: its cumulative
    sum offset by the per-expert counts of the shards of earlier rows (an
    all-gather of [E] integers), so ``keep`` drops exactly the
    reference's pairs. The kept pairs are scattered into a local [E, C, d]
    buffer; slots are disjoint across the batch's shards, so the buffers
    are a ``Partial`` sum, placed by ``act_expert`` (experts over 'model')
    for the expert FFN. Its output is gathered, and each rank combines
    its own pairs. The local parts declare their gradients
    (:func:`repro_torch.models.layers.local_placements`)."""
    mesh = x.device_mesh
    B, S, d = x.shape
    T = B * S
    rows = row_placements(x)
    full, part = local_placements(rows)
    xl = to_local(x, rows)
    Bl = xl.shape[0]
    xf = xl.reshape(Bl * S, d)
    probs, gate_vals, expert_idx = _route(xf, to_local(params["router"]["w"], full, part),
                                          top_k, normalize)
    me = DTensor.from_local(probs.sum(dim=0), mesh, part, run_check=False) / T
    ce = DTensor.from_local(F.one_hot(expert_idx, n_experts).to(torch.float32).sum(dim=(0, 1)),
                            mesh, part, run_check=False) / T
    aux = n_experts * (me * ce).sum()

    cap = capacity(T, top_k, n_experts, capacity_factor)
    counts = F.one_hot(expert_idx.reshape(-1), n_experts).sum(dim=0)
    offset = None
    if any(p.is_shard(0) for p in rows):
        every = DTensor.from_local(counts[None], mesh, rows, run_check=False).full_tensor()
        offset = every[:shard_index(mesh, rows, 0)].sum(dim=0)
    flat_expert, pos_c, keep, buf = _dispatch(xf, expert_idx, n_experts, cap, offset)
    expert_in = shard(DTensor.from_local(buf, mesh, part, run_check=False), "act_expert")
    expert_out = to_local(_experts(params, expert_in, x.dtype), full, part)
    out = _combine(expert_out, flat_expert, pos_c, keep, gate_vals, Bl * S, d)
    return DTensor.from_local(out.reshape(Bl, S, d), mesh, rows, run_check=False), aux
