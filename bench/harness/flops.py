"""The yardstick's arithmetic: published peaks of one NVIDIA H100 SXM and
the operations and bytes of the work a cell asks for.

Frozen copies of ``chip_smoke.py``'s peaks and bounds and of
``repro_torch.kernels.attention``'s FLOP formulas, so that a change to the
program cannot move them. Nothing here imports the program.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit.
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def pairs(S: int, T: int, causal: bool) -> int:
    """(query, key) pairs: query s attends to keys t <= s when causal (the
    triangle, clipped at T), to all T otherwise."""
    if not causal:
        return S * T
    if S <= T:
        return S * (S + 1) // 2
    return T * (T + 1) // 2 + (S - T) * T


def flash_flops(B: int, S: int, T: int, H: int, D: int, causal: bool) -> int:
    """The attention forward: 2 products of 2 D flops per (query, key) pair
    and head."""
    return 4 * B * H * D * pairs(S, T, causal)


def flash_backward_flops(B: int, S: int, T: int, H: int, D: int, causal: bool) -> dict:
    """The forward with lse and each backward kernel: 2 D flops per pair
    and head a product; forward 2 products, dk/dv 4, dq 3; delta 2 D a row."""
    product = flash_flops(B, S, T, H, D, causal) // 2
    return {"fwd": 2 * product, "delta": 2 * B * S * H * D,
            "dkdv": 4 * product, "dq": 3 * product}


def bound_s(nbytes: float, ops: float, ops_rate: float = BF16_OPS_PER_S) -> float:
    """Least seconds of a kernel: the larger of its bytes over the HBM rate
    and its operations over the rate of their type."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_rate)


def flash_bounds(B: int, S: int, H: int, KV: int, D: int, causal: bool = True,
                 esz: int = 2) -> dict:
    """Least seconds of one launch of each attention kernel at a self
    attention shape (T = S): each input read once and each output written
    once, products on the bf16 tensor cores, delta on the CUDA cores."""
    T = S
    ops = flash_backward_flops(B, S, T, H, D, causal)
    rows = B * S * H
    qo = esz * B * S * H * D  # one of q, o, do, dq
    kv = esz * B * T * KV * D  # one of k, v, dk, dv
    return {
        "fwd": bound_s(2 * qo + 2 * kv, ops["fwd"]),
        "fwd_lse": bound_s(2 * qo + 2 * kv + 4 * rows, ops["fwd"]),
        "delta": bound_s(2 * qo + 4 * rows, ops["delta"], F32_OPS_PER_S),
        "dkdv": bound_s(2 * qo + 4 * kv + 8 * rows, ops["dkdv"]),
        "dq": bound_s(3 * qo + 2 * kv + 8 * rows, ops["dq"]),
    }


def active_params(model: dict) -> int:
    """Parameters that multiply a token's activation, of a decoder whose
    every layer is attention then an MLP, or a MoE where the model has
    experts (``model``: the port's sizes, ``registry.port_sizes``): the
    router and the token's ``experts_per_token`` experts count, the input
    embedding (a lookup) does not, the output head does."""
    d, L = model["d_model"], model["n_layers"]
    attn = d * model["head_dim"] * (model["n_heads"] * 2 + model["n_kv_heads"] * 2)
    ffn = 3 * d * model["d_ff"]
    E = model.get("n_experts", 0)
    if E:
        ffn = model["experts_per_token"] * ffn + d * E
    return L * (attn + ffn) + model["vocab_size"] * d


def attention_forward_flops(model: dict, B: int, S: int) -> int:
    """Causal self-attention forward flops of all layers at [B, S]."""
    return model["n_layers"] * flash_flops(B, S, S, model["n_heads"], model["head_dim"], True)


def train_step_flops(model: dict, B: int, S: int) -> float:
    """Model flops of one training step on B x S tokens: 6 x the active
    matmul parameters x tokens, and the causal attention's forward and
    backward (3.5 x the forward's: 2 + 5 products), no recompute."""
    return 6 * active_params(model) * B * S + 3.5 * attention_forward_flops(model, B, S)


def prefill_flops(model: dict, B: int, S: int) -> float:
    """Model flops of one prefill call: 2 x the active matmul parameters x
    tokens and the causal attention's forward; the output head is needed
    at the last position of each row only, so it is counted at B rows."""
    head = model["vocab_size"] * model["d_model"]
    return 2 * (active_params(model) - head) * B * S + 2 * head * B \
        + attention_forward_flops(model, B, S)
