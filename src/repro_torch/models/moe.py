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
tensors. The routing (the stable sort, the cumulative sum, the scatter)
has not been run on DTensors yet.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, init_linear, shard

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


def moe_ffn(
    params: Params,
    x: torch.Tensor,  # [B, S, d]
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    normalize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, S, d], aux load-balance loss scalar)."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)

    logits = (xf @ params["router"]["w"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    gate_vals, expert_idx = route_top_k(probs, top_k)  # [T, k]
    if normalize:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # Auxiliary load-balancing loss (Switch-style).
    me = probs.mean(dim=0)  # [E]
    ce = F.one_hot(expert_idx, n_experts).to(torch.float32).sum(dim=1).mean(dim=0)
    aux = n_experts * (me * ce).sum()

    cap = capacity(T, top_k, n_experts, capacity_factor)

    # Position of each (token, k) pair within its expert's buffer.
    flat_expert = expert_idx.reshape(T * top_k)  # row-major: pair p = t*k + j
    onehot = F.one_hot(flat_expert, n_experts)  # [TK, E]
    pos = (onehot.cumsum(dim=0) - 1).gather(1, flat_expert[:, None])[:, 0]
    keep = pos < cap
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))

    token_of_pair = torch.arange(T * top_k, device=x.device) // top_k
    gathered = torch.where(keep[:, None], xf[token_of_pair], torch.zeros((), dtype=x.dtype,
                                                                        device=x.device))
    expert_in = torch.zeros((n_experts, cap, d), dtype=x.dtype, device=x.device)
    expert_in.index_put_((flat_expert, pos_c), gathered, accumulate=True)
    expert_in = shard(expert_in, "act_expert")

    # Batched expert FFN (SwiGLU).
    wi = params["wi"].to(x.dtype)
    wg = params["wg"].to(x.dtype)
    wo = params["wo"].to(x.dtype)
    h = F.silu(torch.bmm(expert_in, wg)) * torch.bmm(expert_in, wi)
    h = shard(h, "act_expert_ffn")
    expert_out = torch.bmm(h, wo)  # [E, C, d]

    out_pairs = expert_out[flat_expert, pos_c]  # [TK, d]
    out_pairs = out_pairs * (
        gate_vals.reshape(T * top_k, 1).to(x.dtype) * keep[:, None].to(x.dtype)
    )
    out = out_pairs.reshape(T, top_k, d).sum(dim=1)
    return out.reshape(B, S, d), aux
