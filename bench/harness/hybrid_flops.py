"""The yardstick's arithmetic for a hybrid (Jamba) decoder: its model
flops a prefill call and the selective scan's least time. Nothing here
imports the program; the layer pattern is read from the port's sizes as
``bench.harness.hybrid_weights`` reads it."""

from __future__ import annotations

from bench.harness.flops import BF16_OPS_PER_S, F32_OPS_PER_S, bound_s, flash_flops
from bench.harness.hybrid_weights import layer_kinds

# Float32 operations of the scan a (token, channel, state): the decay's
# product, the state's product and fused add, C . s's product and add.
SCAN_OPS = 6

__all__ = ["BF16_OPS_PER_S", "SCAN_OPS", "active_params", "mamba_layers", "prefill_flops",
           "scan_bound_s"]


def _widths(m: dict) -> tuple:
    d = m["d_model"]
    return d, m["ssm_expand"] * d, m["ssm_state_dim"], m["ssm_dt_rank"]


def active_params(m: dict) -> int:
    """Parameters that multiply a token's activation, output head
    included: Mamba-1's four projections (in, x, dt, out), attention's
    q / k / v / o, the MLP's three, or the router and the token's
    ``experts_per_token`` experts."""
    d, di, N, R = _widths(m)
    mamba = d * 2 * di + di * (R + 2 * N) + R * di + di * d
    attn = d * m["head_dim"] * (m["n_heads"] * 2 + m["n_kv_heads"] * 2)
    ffn = 3 * d * m["d_ff"]
    moe = m.get("experts_per_token", 0) * ffn + d * m.get("n_experts", 0)
    total = m["vocab_size"] * d
    for mixer, kind in layer_kinds(m):
        total += (attn if mixer == "attn" else mamba) + (moe if kind == "moe" else ffn)
    return total


def prefill_flops(m: dict, B: int, S: int) -> float:
    """Model flops of one prefill call on [B, S]: 2 x the active matmul
    parameters x tokens, the causal attention's forward on the attention
    layers, and the output head at the last position of each row only."""
    head = m["vocab_size"] * m["d_model"]
    n_attn = sum(mixer == "attn" for mixer, _ in layer_kinds(m))
    attn = n_attn * flash_flops(B, S, S, m["n_heads"], m["head_dim"], True)
    return 2 * (active_params(m) - head) * B * S + 2 * head * B + attn


def scan_bound_s(m: dict, B: int, S: int, esz: int = 2) -> float:
    """Least seconds of one layer's selective scan on [B, S]: the larger of
    its bytes (x, dt, z read and the output written once, B and C read
    once) over the HBM rate and its SCAN_OPS float32 operations a (token,
    channel, state) over the float32 rate."""
    _, di, N, _ = _widths(m)
    tokens = B * S
    return bound_s(esz * tokens * (4 * di + 2 * N), SCAN_OPS * tokens * di * N, F32_OPS_PER_S)


def mamba_layers(m: dict) -> int:
    return sum(mixer == "mamba1" for mixer, _ in layer_kinds(m))
