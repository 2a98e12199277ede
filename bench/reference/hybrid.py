"""The plain reference of the hybrid (Jamba) cells: float32 PyTorch with
TF32 off, no kernels, no cache, written from the published model's
description and not from the program's code. It imports nothing of the
program.

The layer pattern (the port's names of Jamba's keys): attention where
``i % attn_every == attn_offset`` (``attn_layer_period`` /
``attn_layer_offset``), Mamba-1 elsewhere; a mixture of experts where
``i % moe_every == moe_offset`` (``expert_layer_period`` /
``expert_layer_offset``), a SwiGLU MLP elsewhere. Each layer is
RMSNorm, the mixer, a residual add, RMSNorm, the FFN, a residual add.

Attention is ``bench.reference.model``'s grouped causal attention with no
positional encoding (Jamba has none). The mixture of experts is
``bench.reference.model.moe`` with the gates as the softmax gives them
(``router_normalize`` false: Jamba keeps the top two's softmax values).

Mamba-1, on the mixer's normed input h [B, S, d]:
  1. x, z = split(h W_in)                       each [B, S, d_inner]
  2. x = silu(conv(x) + b)                      depthwise, causal, K taps;
                                                w[0] weighs the newest sample
  3. dt_r, B, C = split(x W_x, [R, N, N])
  4. dt_r, B, C = rmsnorm(dt_r), rmsnorm(B), rmsnorm(C)   Jamba's inner norms
  5. delta = softplus(dt_r W_dt + dt_bias)      [B, S, d_inner]
  6. A = -exp(A_log)                            [d_inner, N]
  7. s_t = exp(delta_t A) s_{t-1} + (delta_t x_t) B_t,  s_{-1} = 0
     y_t = s_t . C_t + D x_t
  8. out = (y * silu(z)) W_out
The scan walks the steps in order; each block of steps takes its decays
and inputs in one pass first, then one operation a step.

``prec`` selects how every matrix product is computed, as in
``bench.reference.model``: "f32", or "fp8" (the control). The scan and the
conv are not matrix products and stay in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.model import F32, attention, matmul, mlp, moe, no_tf32, rms_norm

# Elements of one block of the scan's float32 work ([steps, B, d_inner, N]).
SCAN_ELEMENTS = 1 << 25


def layer_kinds(m: dict) -> list[tuple[str, str]]:
    """(mixer, ffn) of every layer: "attn" or "mamba1", "moe" or "mlp"."""
    return [("attn" if i % m["attn_every"] == m["attn_offset"] else "mamba1",
             "moe" if m.get("n_experts") and i % m["moe_every"] == m["moe_offset"] else "mlp")
            for i in range(m["n_layers"])]


def _period(m: dict) -> int:
    kinds = layer_kinds(m)
    n = len(kinds)
    return next(p for p in range(1, n + 1)
                if n % p == 0 and all(kinds[i] == kinds[i % p] for i in range(n)))


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of x [B, S, c] with w [K, c], w[0] on the
    newest sample, and bias b [c]."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = b + xp[:, K - 1:] * w[0]
    for k in range(1, K):
        out = out + xp[:, K - 1 - k:K - 1 - k + S] * w[k]
    return out


def scan(x: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
         Cm: torch.Tensor) -> torch.Tensor:
    """y [B, S, c] of step 7 without the D skip: x, delta [B, S, c], A [c, N],
    Bm, Cm [B, S, N]."""
    Bsz, S, c = x.shape
    N = A.shape[1]
    step = max(1, SCAN_ELEMENTS // (Bsz * c * N))
    s = torch.zeros((Bsz, c, N), dtype=F32, device=x.device)
    ys = []
    for t0 in range(0, S, step):
        d = delta[:, t0:t0 + step].transpose(0, 1)  # [L, B, c]
        decay = torch.exp(d[..., None] * A)  # [L, B, c, N]
        inp = (d * x[:, t0:t0 + step].transpose(0, 1))[..., None] \
            * Bm[:, t0:t0 + step].transpose(0, 1)[:, :, None, :]
        states = torch.empty_like(decay)
        for t in range(decay.shape[0]):
            s = torch.addcmul(inp[t], decay[t], s, out=states[t])
        ys.append((states * Cm[:, t0:t0 + step].transpose(0, 1)[:, :, None, :]).sum(-1))
    return torch.cat(ys, dim=0).transpose(0, 1)


def mamba1(h: torch.Tensor, w: dict, m: dict, prec: str) -> torch.Tensor:
    """Jamba's Mamba-1 mixer over h [B, S, d] (module docstring)."""
    di = m["ssm_expand"] * m["d_model"]
    N = m["ssm_state_dim"]
    R = m["ssm_dt_rank"]
    eps = m.get("norm_eps", 1e-5)
    xz = matmul(h, w["in_proj"], prec)
    x, z = xz[..., :di], xz[..., di:]
    x = F.silu(causal_conv(x, w["conv_w"], w["conv_b"]))
    dbc = matmul(x, w["x_proj"], prec)
    dt = rms_norm(dbc[..., :R], w["dt_norm"], eps)
    Bm = rms_norm(dbc[..., R:R + N], w["b_norm"], eps)
    Cm = rms_norm(dbc[..., R + N:], w["c_norm"], eps)
    delta = F.softplus(matmul(dt, w["dt_proj"], prec) + w["dt_bias"])
    y = scan(x, delta, -torch.exp(w["A_log"]), Bm, Cm) + w["D"] * x
    return matmul(y * F.silu(z), w["out_proj"], prec)


def layer(x, w: dict, m: dict, kinds: tuple, prec: str) -> torch.Tensor:
    """One layer of ``kinds`` (mixer, ffn) on x [B, S, d], weights ``w``
    (float32, by :data:`LEAVES`' names)."""
    B, S, d = x.shape
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps = m.get("norm_eps", 1e-5)
    mixer, ffn = kinds
    h = rms_norm(x, w["mixer_norm"], eps)
    if mixer == "attn":
        q = matmul(h, w["wq"], prec).reshape(B, S, H, hd)
        k = matmul(h, w["wk"], prec).reshape(B, S, KV, hd)
        v = matmul(h, w["wv"], prec).reshape(B, S, KV, hd)
        x = x + matmul(attention(q, k, v, prec).reshape(B, S, H * hd), w["wo_attn"], prec)
    else:
        x = x + mamba1(h, w, m, prec)
    h = rms_norm(x, w["ffn_norm"], eps)
    if ffn == "moe":
        return x + moe(h, w, m, prec)
    return x + mlp(h, w, prec)


# The reference's names of a layer's weights, by the path of the stacked
# leaf below the period position (bench.harness.hybrid_weights.leaf_specs).
LEAVES = {
    ("mixer", "norm", "scale"): "mixer_norm",
    ("mixer", "attn", "wq", "w"): "wq",
    ("mixer", "attn", "wk", "w"): "wk",
    ("mixer", "attn", "wv", "w"): "wv",
    ("mixer", "attn", "wo", "w"): "wo_attn",
    ("mixer", "mamba", "in_proj", "w"): "in_proj",
    ("mixer", "mamba", "conv_w"): "conv_w",
    ("mixer", "mamba", "conv_b"): "conv_b",
    ("mixer", "mamba", "x_proj", "w"): "x_proj",
    ("mixer", "mamba", "dt_norm", "scale"): "dt_norm",
    ("mixer", "mamba", "b_norm", "scale"): "b_norm",
    ("mixer", "mamba", "c_norm", "scale"): "c_norm",
    ("mixer", "mamba", "dt_proj", "w"): "dt_proj",
    ("mixer", "mamba", "dt_bias"): "dt_bias",
    ("mixer", "mamba", "A_log"): "A_log",
    ("mixer", "mamba", "D"): "D",
    ("mixer", "mamba", "out_proj", "w"): "out_proj",
    ("ffn", "norm", "scale"): "ffn_norm",
    ("ffn", "mlp", "wi", "w"): "wi",
    ("ffn", "mlp", "wg", "w"): "wg",
    ("ffn", "mlp", "wo", "w"): "wo",
    ("ffn", "moe", "router", "w"): "router",
    ("ffn", "moe", "wi"): "wi",
    ("ffn", "moe", "wg"): "wg",
    ("ffn", "moe", "wo"): "wo",
}


def layer_weights(leaves: dict, m: dict, i: int) -> dict:
    """Layer ``i``'s weights in float32, by LEAVES' names, from ``leaves``:
    the stacked leaves by path, period position ``i % period`` and repeat
    ``i // period``."""
    P = _period(m)
    j, rep = i % P, i // P
    return {LEAVES[p[2:]]: t[rep].to(F32) for p, t in leaves.items()
            if p[0] == "layers" and p[1] == j}


@torch.no_grad()
def hidden(m: dict, leaves: dict, blocks: list, precs: tuple = ("f32",)) -> dict:
    """{prec: [final hidden [B, S, d] float32 of each token block]}, layer
    by layer over all the blocks together, so that one layer's float32
    weights are held at a time; ``blocks``: [B, S] token ids each."""
    no_tf32()
    table = leaves[("embed", "table")]
    hs = {p: [table[t.to(table.device).long()].to(F32) for t in blocks] for p in precs}
    for i, kinds in enumerate(layer_kinds(m)):
        w = layer_weights(leaves, m, i)
        for p in precs:
            hs[p] = [layer(h, w, m, kinds, p) for h in hs[p]]
        del w
    norm = leaves[("norm", "scale")].to(F32)
    return {p: [rms_norm(h, norm, m.get("norm_eps", 1e-5)) for h in hs[p]] for p in precs}


def _out(leaves: dict, m: dict) -> torch.Tensor:
    return leaves[("embed" if m.get("tie_embeddings") else "out", "table")].to(F32)


@torch.no_grad()
def last_logits(m: dict, leaves: dict, prompts: list, precs: tuple = ("f32",)) -> dict:
    """{prec: [logits [B, V] float32 of each prompt block's last position]}."""
    out = _out(leaves, m)
    hs = hidden(m, leaves, prompts, precs)
    return {p: [matmul(h[:, -1], out.T, p) for h in hs[p]] for p in precs}


@torch.no_grad()
def logits(m: dict, leaves: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Float32 logits [B, S, V] at every position of ``tokens`` [B, S]."""
    h = hidden(m, leaves, [tokens])["f32"][0]
    return h @ _out(leaves, m).T
