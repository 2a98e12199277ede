"""The plain reference of the cells' decoder: float32 PyTorch with TF32
off, no kernels, no cache, written from the model's description and not
from the program's code. It imports nothing of the program.

The decoder: a token embedding; per layer RMSNorm, attention with RoPE
(rotate-half, theta from the configuration), causal softmax over scores
scaled by 1/sqrt(head_dim), query heads sharing key/value heads in groups;
a residual add; RMSNorm and a SwiGLU MLP (silu(x Wg) * (x Wi)) Wo, or a
mixture of experts; a residual add; a final RMSNorm and the output table.

The mixture of experts follows the port's layer, which departs from
Phi-3.5-MoE's (``bench/configs/phi3.5-moe-42b-l16.json`` lists how): a
float32 softmax router; the top k of a stable descending sort, ties to
the lower expert; gates renormalised to sum to one; each expert takes at
most ``max(ceil(T k / E cf), k)`` (token, choice) pairs, in row-major pair
order, and drops the rest; a token's output is the gated sum of its kept
pairs' expert outputs.

``prec`` selects how every matrix product is computed: "f32", or "fp8":
each operand rounded to float8 e4m3 with a per-tensor scale (gradients to
e5m2), products accumulated in float32. "fp8" is the control, the next
precision below the bfloat16 that the configurations compute in.
"""

from __future__ import annotations

import math
import torch
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
# Elements of one block of attention scores (float32: 512 MiB).
SCORE_ELEMENTS = 1 << 27


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` with a per-tensor scale that
    maps its largest magnitude to the type's largest finite value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = amax / top
    return (x / scale).to(dtype).to(F32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round(a, torch.float8_e4m3fn), _round(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        g = _round(g, torch.float8_e5m2)
        if qb.dim() == 2:
            k = qa.shape[-1]
            da = (g @ qb.T).reshape(qa.shape)
            db = qa.reshape(-1, k).T @ g.reshape(-1, g.shape[-1])
            return da, db
        return g @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ g


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return a @ b
    if prec == "fp8":
        return _Fp8Matmul.apply(a, b)
    raise ValueError(prec)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope_tables(S: int, head_dim: int, theta: float, device) -> tuple:
    half = head_dim // 2
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float64),
                          torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(S, dtype=torch.float64)[:, None] * inv[None]
    return torch.cos(ang).to(F32).to(device), torch.sin(ang).to(F32).to(device)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos, sin [S, D/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _heads_attention(q, k, v, prec: str) -> torch.Tensor:
    """Causal attention of q [B, h, S, D] over k, v [B, h, S, D]."""
    S, D = q.shape[-2], q.shape[-1]
    s = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(D)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    s = s.masked_fill(mask, float("-inf"))
    return matmul(torch.softmax(s, dim=-1), v, prec)


def attention(q, k, v, prec: str) -> torch.Tensor:
    """Causal grouped attention: q [B, S, H, D], k and v [B, S, KV, D];
    returns [B, S, H, D]. Heads go in blocks whose scores fit
    SCORE_ELEMENTS; with gradients on each block is recomputed in the
    backward pass, so only its inputs are kept."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2)
    step = max(1, SCORE_ELEMENTS // (B * S * S))
    outs = []
    for h0 in range(0, H, step):
        parts = (qh[:, h0:h0 + step], kh[:, h0:h0 + step], vh[:, h0:h0 + step])
        if torch.is_grad_enabled():
            outs.append(checkpoint(_heads_attention, *parts, prec, use_reentrant=False))
        else:
            outs.append(_heads_attention(*parts, prec))
    return torch.cat(outs, dim=1).transpose(1, 2)


def mlp(h, w: dict, prec: str) -> torch.Tensor:
    g = matmul(h, w["wg"], prec)
    return matmul(torch.nn.functional.silu(g) * matmul(h, w["wi"], prec), w["wo"], prec)


def moe(h, w: dict, m: dict, prec: str) -> torch.Tensor:
    """The port's capacity mixture of experts over h [B, S, d] (module
    docstring)."""
    B, S, d = h.shape
    T, E, k = B * S, m["n_experts"], m["experts_per_token"]
    x = h.reshape(T, d)
    probs = torch.softmax(matmul(x, w["router"], prec), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :k], idx[:, :k]
    if m.get("router_normalize", True):
        gates = gates / gates.sum(dim=-1, keepdim=True)
    cap = max(int(math.ceil(T * k / E * m.get("capacity_factor", 1.25))), k)
    flat = experts.reshape(-1)  # pair p = t k + j
    token = torch.arange(T * k, device=h.device) // k
    out = torch.zeros_like(x)
    for e in range(E):
        mine = flat == e
        slot = torch.cumsum(mine.to(torch.int64), dim=0) - 1
        pairs = torch.nonzero(mine & (slot < cap)).reshape(-1)
        if pairs.numel() == 0:
            continue
        xe = x[token[pairs]]
        ye = mlp(xe, {"wi": w["wi"][e], "wg": w["wg"][e], "wo": w["wo"][e]}, prec)
        out = out.index_add(0, token[pairs], ye * gates.reshape(-1)[pairs, None])
    return out.reshape(B, S, d)


def layer(x, w: dict, m: dict, cos, sin, prec: str) -> torch.Tensor:
    """One decoder layer on x [B, S, d] with its weights ``w`` (float32)."""
    B, S, d = x.shape
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps = m.get("norm_eps", 1e-5)
    h = rms_norm(x, w["attn_norm"], eps)
    q = rope(matmul(h, w["wq"], prec).reshape(B, S, H, hd), cos, sin)
    kk = rope(matmul(h, w["wk"], prec).reshape(B, S, KV, hd), cos, sin)
    v = matmul(h, w["wv"], prec).reshape(B, S, KV, hd)
    x = x + matmul(attention(q, kk, v, prec).reshape(B, S, H * hd), w["wo_attn"], prec)
    h = rms_norm(x, w["ffn_norm"], eps)
    if m.get("n_experts", 0):
        return x + moe(h, w, m, prec)
    return x + mlp(h, w, prec)


# The reference's names of a layer's weights, by the path of the stacked
# leaf they come from (bench.harness.weights.leaf_specs).
LAYER_LEAVES = {
    ("mixer", "norm", "scale"): "attn_norm",
    ("mixer", "attn", "wq", "w"): "wq",
    ("mixer", "attn", "wk", "w"): "wk",
    ("mixer", "attn", "wv", "w"): "wv",
    ("mixer", "attn", "wo", "w"): "wo_attn",
    ("ffn", "norm", "scale"): "ffn_norm",
    ("ffn", "mlp", "wi", "w"): "wi",
    ("ffn", "mlp", "wg", "w"): "wg",
    ("ffn", "mlp", "wo", "w"): "wo",
    ("ffn", "moe", "router", "w"): "router",
    ("ffn", "moe", "wi"): "wi",
    ("ffn", "moe", "wg"): "wg",
    ("ffn", "moe", "wo"): "wo",
}


def layer_weights(leaves: dict, layer_index: int) -> dict:
    """Layer ``layer_index``'s weights in float32, by LAYER_LEAVES' names,
    from ``leaves``: the stacked leaves by path (``bench.harness.weights``)."""
    return {LAYER_LEAVES[p[2:]]: t[layer_index].to(F32)
            for p, t in leaves.items() if p[0] == "layers"}
