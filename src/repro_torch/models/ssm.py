"""State-space and recurrent mixers: SSD (Mamba-2 style) and xLSTM blocks
(counterpart of ``repro.models.ssm``).

SSD runs the chunked formulation: the intra-chunk work is Q x Q products,
the inter-chunk pass a Python loop over the chunk boundary states (the
JAX package's ``lax.scan``, ``ssm.py:140-149``). Decode is the O(1)
recurrent update. The mLSTM takes the stabilized parallel (quadratic) form
for a whole sequence and the matrix-memory recurrent form for decode; the
sLSTM is sequential, a Python loop over time around the cell
(``ssm.py:400``) with the input projection hoisted out of it.

None of these loops is a kernel of the JAX package (no ``pallas_call``):
they run as PyTorch ops here, on the card as on the CPU.

Rounding points kept from the JAX package:
  * SSD's decay matrix and ``C . B`` stay in float32 (``ssm.py:112-114``);
  * ``k / np.sqrt(P)`` in the mLSTM is float32 in JAX whatever ``k``'s
    type (a numpy scalar is not weakly typed there), so ``k`` is float32
    from that division on (``ssm.py:265``, ``:320``);
  * ``jax.nn.gelu`` is the tanh approximation (``ssm.py:405``, ``:430``);
  * the sLSTM's decode state holds ``h`` in bfloat16 (``ssm.py:409-416``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _normal, init_linear, init_rms_norm, linear, rms_norm

Params = dict[str, Any]

__all__ = [
    "init_ssd", "ssd_forward", "ssd_init_state", "ssd_decode_step",
    "init_mlstm", "mlstm_forward", "mlstm_init_state", "mlstm_decode_step",
    "init_slstm", "slstm_forward", "slstm_init_state", "slstm_decode_step",
]

F32 = torch.float32


# ==========================================================================
# SSD (Mamba-2 style)
# ==========================================================================

def init_ssd(gen: torch.Generator, cfg: ModelConfig, dtype=F32) -> Params:
    d, di, H, N = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state_dim
    dev = gen.device
    return {
        "wz": init_linear(gen, d, di, dtype=dtype),
        "wx": init_linear(gen, d, di, dtype=dtype),
        "wbc": init_linear(gen, d, 2 * N, dtype=dtype),
        "wdt": init_linear(gen, d, H, dtype=dtype),
        "conv_w": _normal(gen, (cfg.ssm_conv_dim, di), 1.0 / math.sqrt(cfg.ssm_conv_dim), dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=F32, device=dev)).to(dtype),
        "D": torch.ones((H,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((H,), dtype=dtype, device=dev),
        "norm": init_rms_norm(di, dev, dtype),
        "out_proj": init_linear(gen, di, d, dtype=dtype),
    }


def _split_ssd(cfg: ModelConfig, params: Params, u: torch.Tensor):
    N = cfg.ssm_state_dim
    z = linear(params["wz"], u)
    x = linear(params["wx"], u)
    bc = linear(params["wbc"], u)
    Bm, Cm = bc[..., :N], bc[..., N:]
    dt = linear(params["wdt"], u)
    return z, x, Bm, Cm, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: [B, S, di]; w: [K, di]; ``w[0]``
    multiplies the newest sample (``ssm.py:69-77``)."""
    K = w.shape[0]
    S = x.shape[1]
    wc = w.to(x.dtype)
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):  # K is tiny (4); unrolled adds
        out = out + pad[:, k : k + S, :] * wc[K - 1 - k]
    return out + b.to(x.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """segsum[..., i, j] = sum_{t=j+1..i} a[..., t] for i >= j else -inf.

    a: [..., Q]; returns [..., Q, Q].
    """
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full_like(diff, -math.inf))


def ssd_scan(
    x: torch.Tensor,    # [B, S, H, P] inputs (already dt-scaled)
    a: torch.Tensor,    # [B, S, H] log-decay per step (<= 0)
    Bm: torch.Tensor,   # [B, S, N] input matrix (shared across heads)
    Cm: torch.Tensor,   # [B, S, N] output matrix
    chunk: int,
    init_state: torch.Tensor | None = None,  # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: returns (y [B, S, H, P], final_state [B, H, P, N] f32)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} must be divisible by ssm_chunk {Q}")
    nc = S // Q
    xr = x.reshape(B, nc, Q, H, P)
    ar = a.reshape(B, nc, Q, H).to(F32)
    Br = Bm.reshape(B, nc, Q, N)
    Cr = Cm.reshape(B, nc, Q, N)

    cum = torch.cumsum(ar, dim=2)                       # [B,nc,Q,H]
    # Intra-chunk (diagonal) term: att[i,j] = C_i.B_j exp(cum_i - cum_j), i>=j,
    # in float32 (the decay matrix in bf16 breaks decode/forward consistency).
    L = torch.exp(_segsum(ar.permute(0, 1, 3, 2)))      # [B,nc,H,Q,Q]
    cb = torch.einsum("bcin,bcjn->bcij", Cr.to(F32), Br.to(F32))
    att = cb[:, :, None] * L                            # [B,nc,H,Q,Q] f32
    y_diag = torch.einsum("bchij,bcjhp->bcihp", att, xr.to(F32)).to(x.dtype)

    # Chunk boundary states: state_c = sum_j exp(cum_last - cum_j) x_j B_j^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)   # [B,nc,Q,H]
    states = torch.einsum(
        "bcqhp,bcqn->bchpn", decay_to_end.to(x.dtype)[..., None] * xr, Br.to(x.dtype)
    )                                                   # [B,nc,H,P,N]
    chunk_decay = torch.exp(cum[:, :, -1, :])           # [B,nc,H]

    carry = (
        init_state.to(F32)
        if init_state is not None
        else torch.zeros((B, H, P, N), dtype=F32, device=x.device)
    )
    prev = []
    for c in range(nc):
        prev.append(carry)  # the state BEFORE chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c].to(F32)
    prev_states = torch.stack(prev, dim=1)              # [B,nc,H,P,N]

    # Inter-chunk (off-diagonal) term: y_i += C_i . prev_state * exp(cum_i)
    y_off = (
        torch.einsum("bcqn,bchpn->bcqhp", Cr.to(F32), prev_states)
        * torch.exp(cum)[..., None]
    ).to(x.dtype)

    y = (y_diag + y_off).reshape(B, S, H, P)
    return y, carry


def ssd_forward(
    params: Params,
    cfg: ModelConfig,
    u: torch.Tensor,  # [B, S, d_model]
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full SSD mixer; returns (output [B, S, d], final ssm state)."""
    B, S, _ = u.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, x, Bm, Cm, dt = _split_ssd(cfg, params, u)
    x = F.silu(_causal_conv(x, params["conv_w"], params["conv_b"]))
    dt = F.softplus(dt.to(F32) + params["dt_bias"])  # [B,S,H]
    A = -torch.exp(params["A_log"])  # [H]
    a = dt * A  # log decay
    xh = x.reshape(B, S, H, P)
    x_dt = xh * dt[..., None].to(x.dtype)
    y, state = ssd_scan(x_dt, a, Bm, Cm, cfg.ssm_chunk, init_state)
    y = y + params["D"].to(x.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, cfg.d_inner)
    y = rms_norm(params["norm"], y * F.silu(z), cfg.norm_eps)
    return linear(params["out_proj"], y), state


def ssd_init_state(cfg: ModelConfig, batch: int, device=None) -> dict[str, torch.Tensor]:
    return {
        "ssm": torch.zeros(
            (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state_dim),
            dtype=F32, device=device,
        ),
        "conv": torch.zeros(
            (batch, cfg.ssm_conv_dim - 1, cfg.d_inner), dtype=torch.bfloat16, device=device
        ),
    }


def ssd_decode_step(
    params: Params,
    cfg: ModelConfig,
    u: torch.Tensor,  # [B, 1, d_model]
    state: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    B = u.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, x, Bm, Cm, dt = _split_ssd(cfg, params, u)
    x = x[:, 0]  # [B, di]
    # Rolling causal conv buffer, oldest..newest.
    conv_in = torch.cat([state["conv"].to(x.dtype), x[:, None, :]], dim=1)  # [B, K, di]
    # Match _causal_conv's orientation: w[0] multiplies the NEWEST sample.
    w = params["conv_w"].to(x.dtype).flip(0)
    xc = torch.einsum("bkd,kd->bd", conv_in, w) + params["conv_b"].to(x.dtype)
    xc = F.silu(xc)
    new_conv = conv_in[:, 1:, :].to(torch.bfloat16)

    dtp = F.softplus(dt[:, 0].to(F32) + params["dt_bias"])  # [B,H]
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dtp * A)  # [B,H]
    xh = xc.reshape(B, H, P)
    s = state["ssm"]
    s = s * decay[..., None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", xh.to(F32), Bm[:, 0].to(F32), dtp
    )
    y = torch.einsum("bhpn,bn->bhp", s, Cm[:, 0].to(F32)).to(u.dtype)
    y = y + params["D"].to(u.dtype)[None, :, None] * xh
    y = y.reshape(B, 1, cfg.d_inner)
    y = rms_norm(params["norm"], y * F.silu(z), cfg.norm_eps)
    return linear(params["out_proj"], y), {"ssm": s, "conv": new_conv}


# ==========================================================================
# mLSTM (matrix-memory LSTM, xLSTM)
# ==========================================================================

def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype=F32) -> Params:
    d, di = cfg.d_model, cfg.d_inner
    H = cfg.n_heads
    return {
        "up": init_linear(gen, d, 2 * di, dtype=dtype),     # (x, gate z)
        "wq": init_linear(gen, di, di, dtype=dtype),
        "wk": init_linear(gen, di, di, dtype=dtype),
        "wv": init_linear(gen, di, di, dtype=dtype),
        "wif": init_linear(gen, di, 2 * H, dtype=dtype),    # input/forget gate logits
        "norm": init_rms_norm(di, gen.device, dtype),
        "down": init_linear(gen, di, d, dtype=dtype),
    }


def mlstm_forward(
    params: Params, cfg: ModelConfig, u: torch.Tensor
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Stabilized parallel mLSTM. Returns (out [B, S, d], final state)."""
    B, S, _ = u.shape
    H = cfg.n_heads
    di = cfg.d_inner
    P = di // H
    xz = linear(params["up"], u)
    x, z = xz[..., :di], xz[..., di:]
    q = linear(params["wq"], x).reshape(B, S, H, P)
    k = linear(params["wk"], x).reshape(B, S, H, P).to(F32) / math.sqrt(P)
    v = linear(params["wv"], x).reshape(B, S, H, P)
    gif = linear(params["wif"], x).to(F32)
    log_i = gif[..., :H]                       # [B,S,H]
    log_f = F.logsigmoid(gif[..., H:])         # [B,S,H]

    # D[i,j] = sum_{t=j+1..i} log_f_t + log_i_j  (i >= j)
    fseg = _segsum(log_f.permute(0, 2, 1))     # [B,H,S,S]
    Dm = fseg + log_i.permute(0, 2, 1)[:, :, None, :]
    m = Dm.amax(dim=-1, keepdim=True)          # [B,H,S,1] stabilizer
    m = torch.clamp_min(m, -1e30)              # guard all -inf rows
    W = torch.exp(Dm - m)                      # [B,H,S,S]
    qk = torch.einsum("bihp,bjhp->bhij", q.to(F32), k)
    Wqk = W * qk
    num = torch.einsum("bhij,bjhp->bihp", Wqk, v.to(F32))
    den = Wqk.sum(dim=-1)
    den = torch.maximum(den.abs(), torch.exp(-m[..., 0]))
    h = (num / den.permute(0, 2, 1)[..., None]).to(u.dtype)  # [B,S,H,P]
    h = h.reshape(B, S, di)
    h = rms_norm(params["norm"], h, cfg.norm_eps) * F.silu(z)
    out = linear(params["down"], h)

    # Final recurrent state (for decode continuation after prefill).
    cum_f = torch.cumsum(log_f, dim=1)  # [B,S,H]
    logw = cum_f[:, -1:, :] - cum_f + log_i  # weight of each step in the final state
    w_last = torch.exp(logw)
    vf = v.to(F32)
    C = torch.einsum("bsh,bshp,bshq->bhpq", w_last, k, vf)
    n = torch.einsum("bsh,bshp->bhp", w_last, k)
    state = {"C": C, "n": n, "m": logw.amax(dim=1)}
    return out, state


def mlstm_init_state(cfg: ModelConfig, batch: int, device=None) -> dict[str, torch.Tensor]:
    H = cfg.n_heads
    P = cfg.d_inner // H
    return {
        "C": torch.zeros((batch, H, P, P), dtype=F32, device=device),
        "n": torch.zeros((batch, H, P), dtype=F32, device=device),
        "m": torch.full((batch, H), -1e30, dtype=F32, device=device),
    }


def mlstm_decode_step(
    params: Params, cfg: ModelConfig, u: torch.Tensor, state: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    B = u.shape[0]
    H = cfg.n_heads
    di = cfg.d_inner
    P = di // H
    xz = linear(params["up"], u)
    x, z = xz[..., :di], xz[..., di:]
    q = linear(params["wq"], x).reshape(B, H, P)
    k = linear(params["wk"], x).reshape(B, H, P).to(F32) / math.sqrt(P)
    v = linear(params["wv"], x).reshape(B, H, P)
    gif = linear(params["wif"], x)[:, 0].to(F32)
    log_i = gif[:, :H]
    log_f = F.logsigmoid(gif[:, H:])

    m_new = torch.maximum(log_f + state["m"], log_i)
    a = torch.exp(log_f + state["m"] - m_new)[..., None]
    b = torch.exp(log_i - m_new)[..., None]
    C = state["C"] * a[..., None] + b[..., None] * torch.einsum(
        "bhp,bhq->bhpq", k, v.to(F32)
    )
    n = state["n"] * a + b * k
    qf = q.to(F32)
    num = torch.einsum("bhpq,bhp->bhq", C, qf)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", n, qf).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).to(u.dtype).reshape(B, 1, di)
    h = rms_norm(params["norm"], h, cfg.norm_eps) * F.silu(z)
    return linear(params["down"], h), {"C": C, "n": n, "m": m_new}


# ==========================================================================
# sLSTM (scalar-memory LSTM with exponential gating; sequential)
# ==========================================================================

def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype=F32) -> Params:
    d = cfg.d_model
    # 4 gates (z, i, f, o) from input and recurrent h.
    return {
        "wx": init_linear(gen, d, 4 * d, dtype=dtype),
        "wh": init_linear(gen, d, 4 * d, scale=0.5 / math.sqrt(d), dtype=dtype),
        "norm": init_rms_norm(d, gen.device, dtype),
        "up": init_linear(gen, d, 2 * (4 * d // 3), dtype=dtype),
        "down": init_linear(gen, 4 * d // 3, d, dtype=dtype),
    }


def _slstm_cell(params: Params, d: int, gx_t: torch.Tensor, carry):
    """One sLSTM step. carry = (c, n, m, h); gx_t = precomputed W_x x_t.
    Only the recurrent W_h h_{t-1} is inside the time loop."""
    c, n, m, h = carry
    g = (gx_t + linear(params["wh"], h)).to(F32)
    zt = torch.tanh(g[..., :d])
    it = g[..., d : 2 * d]
    ft = g[..., 2 * d : 3 * d]
    ot = torch.sigmoid(g[..., 3 * d :])
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    ia = torch.exp(it - m_new)
    fa = torch.exp(log_f + m - m_new)
    c_new = fa * c + ia * zt
    n_new = fa * n + ia
    h_new = (ot * c_new / torch.clamp_min(n_new, 1.0)).to(gx_t.dtype)
    return (c_new, n_new, m_new, h_new), h_new


def _slstm_out(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(params["norm"], h, cfg.norm_eps)
    up = linear(params["up"], h)
    half = up.shape[-1] // 2
    # jax.nn.gelu's default is the tanh approximation.
    h = F.gelu(up[..., :half], approximate="tanh") * up[..., half:]
    return linear(params["down"], h)


def slstm_forward(
    params: Params, cfg: ModelConfig, u: torch.Tensor
) -> tuple[torch.Tensor, tuple]:
    B, S, d = u.shape
    carry = (
        torch.zeros((B, d), dtype=F32, device=u.device),
        torch.zeros((B, d), dtype=F32, device=u.device),
        torch.full((B, d), -1e30, dtype=F32, device=u.device),
        torch.zeros((B, d), dtype=u.dtype, device=u.device),
    )
    gx = linear(params["wx"], u)  # [B, S, 4d]: hoisted input projection
    hs = []
    for t in range(S):
        carry, h_t = _slstm_cell(params, d, gx[:, t], carry)
        hs.append(h_t)
    return _slstm_out(params, cfg, torch.stack(hs, dim=1)), carry


def slstm_init_state(cfg: ModelConfig, batch: int, device=None) -> tuple:
    d = cfg.d_model
    return (
        torch.zeros((batch, d), dtype=F32, device=device),
        torch.zeros((batch, d), dtype=F32, device=device),
        torch.full((batch, d), -1e30, dtype=F32, device=device),
        torch.zeros((batch, d), dtype=torch.bfloat16, device=device),
    )


def slstm_decode_step(
    params: Params, cfg: ModelConfig, u: torch.Tensor, state: tuple
) -> tuple[torch.Tensor, tuple]:
    d = cfg.d_model
    x_t = u[:, 0]
    gx_t = linear(params["wx"], x_t)
    c, n, m, h = state
    carry, h_new = _slstm_cell(params, d, gx_t, (c, n, m, h.to(x_t.dtype)))
    out = _slstm_out(params, cfg, h_new[:, None, :])
    c, n, m, hh = carry
    return out, (c, n, m, hh.to(torch.bfloat16))
