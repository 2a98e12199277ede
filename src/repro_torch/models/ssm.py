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

Under a mesh (``u`` a DTensor) the projections, the gated norms and the
output projections run as DTensor ops, and the scans on each rank's local
rows and heads (:func:`_sharded_ssd`, :func:`_sharded_mlstm`, the sLSTM's
time loop), each local input's gradient declared as
``layers.local_placements`` says. A decode step under a mesh runs on each
rank's own rows (``lm._recurrent_decode``), the SSD's on its rows and heads
(:func:`_sharded_ssd_step`).

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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    _normal,
    init_linear,
    init_rms_norm,
    linear,
    local_placements,
    merge_heads,
    rms_norm,
    row_placements,
    split_heads,
    to_local,
)

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
    z, x, Bm, Cm, dt = _split_ssd(cfg, params, u)
    if isinstance(u, DTensor):
        y, state = _sharded_ssd(params, cfg, u, x, Bm, Cm, dt, init_state)
    else:
        y, state = _ssd_core(params, cfg, x, Bm, Cm, dt, init_state)
    y = rms_norm(params["norm"], y * F.silu(z), cfg.norm_eps)
    return linear(params["out_proj"], y), state


def _ssd_core(p: Params, cfg: ModelConfig, x, Bm, Cm, dt, init_state):
    """The conv, the gates and the scan of :func:`ssd_forward` on plain
    tensors of any number of heads (``dt``'s last dim; ``p`` holds their
    ``conv_w``, ``conv_b``, ``dt_bias``, ``A_log`` and ``D``): (y [B, S,
    H * P] before the gated norm, final state [B, H, P, N])."""
    B, S, di = x.shape
    H, P = dt.shape[-1], cfg.ssm_head_dim
    x = F.silu(_causal_conv(x, p["conv_w"], p["conv_b"]))
    dt = F.softplus(dt.to(F32) + p["dt_bias"])  # [B,S,H]
    A = -torch.exp(p["A_log"])  # [H]
    a = dt * A  # log decay
    xh = x.reshape(B, S, H, P)
    x_dt = xh * dt[..., None].to(x.dtype)
    y, state = ssd_scan(x_dt, a, Bm, Cm, cfg.ssm_chunk, init_state)
    y = y + p["D"].to(x.dtype)[None, None, :, None] * xh
    return y.reshape(B, S, di), state


def _head_split(mesh, rows: list, n_heads: int) -> dict[int, int]:
    """The mesh dims that split the heads (mesh dim -> 2, the heads' dim of
    [B, S, H, ...]): those that do not split the batch, outer first, while
    the product of their extents divides ``n_heads``."""
    out, n = {}, 1
    for i, p in enumerate(rows):
        if not p.is_shard(0) and n_heads % (n * mesh.size(i)) == 0:
            out[i] = 2
            n *= mesh.size(i)
    return out


def _heads_placements(rows: list, heads: dict[int, int], dim: int) -> list:
    """``rows`` with the heads' mesh dims splitting tensor dim ``dim``."""
    return [Shard(dim) if i in heads else p for i, p in enumerate(rows)]


def _sharded_ssd(params: Params, cfg: ModelConfig, u: DTensor, x, Bm, Cm, dt, init_state):
    """:func:`_ssd_core` of DTensors, on each rank's rows and heads.

    The batch follows ``u``'s split and the heads 'model' (as ``wx``'s
    columns split ``d_inner``, a whole number of heads a rank); ``dt``,
    ``conv_w``, ``conv_b``, ``dt_bias``, ``A_log`` and ``D`` are sliced to
    the rank's heads, and ``Bm`` / ``Cm``, shared across heads, are
    whole on every rank (their gradient a ``Partial`` sum over the heads'
    ranks). Each (row, head) of the conv and the scan is independent, so
    the local result is exact; the output is a DTensor split as its
    inputs, which the gated norm reduces across 'model' as DTensor ops.
    The scan is written out on local tensors because DTensor's strategies
    are op by op: its chunk loop and cumulative sums would each pay
    DTensor's host time (and a redistribution where a strategy wants one)."""
    mesh = u.device_mesh
    rows = row_placements(u)
    heads = _head_split(mesh, rows, cfg.ssm_heads)
    pl = _heads_placements(rows, heads, 2)
    shared = [Partial() if i in heads else p for i, p in enumerate(rows)]
    xl, dtl = to_local(x, pl), to_local(dt, pl)
    Bl, Cl = to_local(Bm, rows, shared), to_local(Cm, rows, shared)
    p = {}
    for key, dim in (("conv_w", 1), ("conv_b", 0), ("dt_bias", 0), ("A_log", 0), ("D", 0)):
        p[key] = to_local(params[key], *local_placements(rows, {i: dim for i in heads}))
    state_pl = _heads_placements(rows, heads, 1)
    st = None if init_state is None else to_local(init_state, state_pl)
    y, state = _ssd_core(p, cfg, xl, Bl, Cl, dtl, st)
    return (DTensor.from_local(y, mesh, pl, run_check=False),
            DTensor.from_local(state, mesh, state_pl, run_check=False))


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
    z, x, Bm, Cm, dt = _split_ssd(cfg, params, u)
    if isinstance(u, DTensor):
        y, new = _sharded_ssd_step(params, cfg, x, Bm, Cm, dt, state)
    else:
        y, new = _ssd_step_core(params, cfg, x[:, 0], Bm[:, 0], Cm[:, 0], dt[:, 0], state)
    y = y.reshape(B, 1, cfg.d_inner)
    y = rms_norm(params["norm"], y * F.silu(z), cfg.norm_eps)
    return linear(params["out_proj"], y), new


def _ssd_step_core(p: Params, cfg: ModelConfig, x, Bm, Cm, dt, state):
    """The conv and the state update of one SSD decode step on plain
    tensors of any number of heads (``dt``'s last dim; ``p`` holds their
    ``conv_w``, ``conv_b``, ``dt_bias``, ``A_log`` and ``D``): x [B, H * P],
    Bm, Cm [B, N], dt [B, H] -> (y [B, H * P] before the gated norm, the
    new state)."""
    B, H, P = x.shape[0], dt.shape[-1], cfg.ssm_head_dim
    # Rolling causal conv buffer, oldest..newest.
    conv_in = torch.cat([state["conv"].to(x.dtype), x[:, None, :]], dim=1)  # [B, K, di]
    # Match _causal_conv's orientation: w[0] multiplies the NEWEST sample.
    w = p["conv_w"].to(x.dtype).flip(0)
    xc = torch.einsum("bkd,kd->bd", conv_in, w) + p["conv_b"].to(x.dtype)
    xc = F.silu(xc)
    new_conv = conv_in[:, 1:, :].to(torch.bfloat16)

    dtp = F.softplus(dt.to(F32) + p["dt_bias"])  # [B,H]
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dtp * A)  # [B,H]
    xh = xc.reshape(B, H, P)
    s = state["ssm"]
    s = s * decay[..., None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", xh.to(F32), Bm.to(F32), dtp
    )
    y = torch.einsum("bhpn,bn->bhp", s, Cm.to(F32)).to(x.dtype)
    y = y + p["D"].to(x.dtype)[None, :, None] * xh
    return y.reshape(B, H * P), {"ssm": s, "conv": new_conv}


def _sharded_ssd_step(params: Params, cfg: ModelConfig, x, Bm, Cm, dt, state):
    """:func:`_ssd_step_core` of DTensors on each rank's rows and heads.

    The state is placed by ``cache_sharding`` (``ssm`` [B, H, P, N] over
    the batch and its heads, ``conv`` [B, K-1, d_inner] over the batch and
    its channels, both on 'model'; or replicated, as the serving launcher
    leaves it). Each (row, head) of the conv and the update is
    independent, so each rank steps its own rows and heads on its local
    storage: ``x`` and ``dt`` redistributed to the state's split (a
    reduce-scatter of their partial sums over 'model', or a slice),
    ``Bm`` / ``Cm`` (shared by the heads) to the rows, and the per-head
    parameters sliced. The new state is returned as DTensors placed as the
    state, and ``y`` split over the heads as ``x``, for the gated norm and
    the output projection (DTensor ops). Where the conv's channels are not
    split as the state's heads are, the state is gathered to the rows
    first (an all-gather over the mesh dims that split it), and the new
    state's own shards are kept."""
    ssm_st, conv_st = state["ssm"], state["conv"]
    mesh = ssm_st.device_mesh
    rows = [p if p.is_shard(0) else Replicate() for p in ssm_st.placements]
    heads = [i for i, p in enumerate(ssm_st.placements) if p.is_shard(1)]
    chans = [i for i, p in enumerate(conv_st.placements) if p.is_shard(2)]
    if heads != chans:
        heads = []
    split = _heads_placements(rows, dict.fromkeys(heads, 2), 2)  # [B, 1, H or di]
    xl, dtl = (t.redistribute(mesh, split).to_local()[:, 0] for t in (x, dt))
    Bl, Cl = (t.redistribute(mesh, rows).to_local()[:, 0] for t in (Bm, Cm))
    p = {key: params[key].redistribute(mesh, [Shard(dim) if i in heads else Replicate()
                                              for i in range(mesh.ndim)]).to_local()
         for key, dim in (("conv_w", 1), ("conv_b", 0), ("dt_bias", 0), ("A_log", 0), ("D", 0))}
    st_pl = {"ssm": _heads_placements(rows, dict.fromkeys(heads, 1), 1),
             "conv": _heads_placements(rows, dict.fromkeys(heads, 2), 2)}
    local = {k: state[k].redistribute(mesh, st_pl[k]).to_local() for k in state}
    y, new = _ssd_step_core(p, cfg, xl, Bl, Cl, dtl, local)
    new = {k: DTensor.from_local(v, mesh, st_pl[k], run_check=False).redistribute(
        mesh, state[k].placements) for k, v in new.items()}
    return DTensor.from_local(y[:, None], mesh, split, run_check=False), new


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
    if isinstance(xz, DTensor):
        # ``up``'s column split puts x and z on different ranks: gather the
        # columns before the slice.
        xz = xz.redistribute(xz.device_mesh, row_placements(xz))
    x, z = xz[..., :di], xz[..., di:]
    q = split_heads(linear(params["wq"], x), (B, S, H, P))
    k = split_heads(linear(params["wk"], x), (B, S, H, P))
    v = split_heads(linear(params["wv"], x), (B, S, H, P))
    gif = linear(params["wif"], x).to(F32)
    gi, gf = gif[..., :H], gif[..., H:]
    if isinstance(u, DTensor):
        h, state = _sharded_mlstm(u, q, k, v, gi, gf)
    else:
        h, state = _mlstm_core(q, k, v, gi, gf)
    h = merge_heads(h)
    h = rms_norm(params["norm"], h, cfg.norm_eps) * F.silu(z)
    return linear(params["down"], h), state


def _mlstm_core(q, k, v, gi, gf) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The parallel form on plain tensors q, k, v [B, S, H, P] and the gate
    logits [B, S, H] (float32): (h [B, S, H, P] in q's type, final
    state)."""
    P = q.shape[-1]
    k = k.to(F32) / math.sqrt(P)
    log_i = gi                                 # [B,S,H]
    log_f = F.logsigmoid(gf)                   # [B,S,H]

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
    h = (num / den.permute(0, 2, 1)[..., None]).to(q.dtype)  # [B,S,H,P]

    # Final recurrent state (for decode continuation after prefill).
    cum_f = torch.cumsum(log_f, dim=1)  # [B,S,H]
    logw = cum_f[:, -1:, :] - cum_f + log_i  # weight of each step in the final state
    w_last = torch.exp(logw)
    vf = v.to(F32)
    C = torch.einsum("bsh,bshp,bshq->bhpq", w_last, k, vf)
    n = torch.einsum("bsh,bshp->bhp", w_last, k)
    return h, {"C": C, "n": n, "m": logw.amax(dim=1)}


def _sharded_mlstm(u: DTensor, q, k, v, gi, gf):
    """:func:`_mlstm_core` of DTensors on each rank's rows and heads (the
    parallel form is independent per (row, head), so the local result is
    exact): h split as q, the state over the same rows and heads. Written
    out on local tensors because DTensor has no strategy for the backward
    of ``logsigmoid`` (``aten.log_sigmoid_backward``, torch 2.13)."""
    mesh = u.device_mesh
    rows = row_placements(u)
    heads = _head_split(mesh, rows, q.shape[2])
    pl = _heads_placements(rows, heads, 2)
    h, state = _mlstm_core(*(to_local(t, pl) for t in (q, k, v, gi, gf)))
    state_pl = _heads_placements(rows, heads, 1)
    return (DTensor.from_local(h, mesh, pl, run_check=False),
            {key: DTensor.from_local(t, mesh, state_pl, run_check=False)
             for key, t in state.items()})


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


def _slstm_cell(wh: Params, d: int, gx_t: torch.Tensor, carry):
    """One sLSTM step. carry = (c, n, m, h); gx_t = precomputed W_x x_t.
    Only the recurrent W_h h_{t-1} (``wh``, the recurrent linear's
    parameters) is inside the time loop."""
    c, n, m, h = carry
    g = (gx_t + linear(wh, h)).to(F32)
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
    gx = linear(params["wx"], u)  # [B, S, 4d]: hoisted input projection
    if not isinstance(u, DTensor):
        hs, carry = _slstm_scan(params["wh"], gx)
        return _slstm_out(params, cfg, hs), carry
    # Under a mesh the time loop runs on plain local tensors: the gate
    # inputs and ``wh`` gathered to full width once a layer, this rank's
    # rows of the batch, and every rank that shares those rows repeating
    # the loop (so the gathered tensors' gradients are Replicate over its
    # other mesh dims, and ``wh``'s a Partial sum over the batch's). A loop
    # of DTensor ops would pay DTensor's host time on every op of every
    # step.
    mesh = u.device_mesh
    rows = row_placements(u)
    wh = {key: to_local(w, *local_placements(rows)) for key, w in params["wh"].items()}
    hs, carry = _slstm_scan(wh, to_local(gx, rows))
    hs = DTensor.from_local(hs, mesh, rows, run_check=False)
    carry = tuple(DTensor.from_local(t, mesh, rows, run_check=False) for t in carry)
    return _slstm_out(params, cfg, hs), carry


def _zero_carry(gx: torch.Tensor) -> tuple:
    B, d = gx.shape[0], gx.shape[-1] // 4
    return (
        torch.zeros((B, d), dtype=F32, device=gx.device),
        torch.zeros((B, d), dtype=F32, device=gx.device),
        torch.full((B, d), -1e30, dtype=F32, device=gx.device),
        torch.zeros((B, d), dtype=gx.dtype, device=gx.device),
    )


def _slstm_scan(wh: Params, gx: torch.Tensor) -> tuple[torch.Tensor, tuple]:
    """The sLSTM time loop over plain gate inputs gx [B, S, 4d] from a zero
    state: (h [B, S, d], final carry)."""
    B, S, d4 = gx.shape
    d = d4 // 4
    carry = _zero_carry(gx)
    hs = []
    for t in range(S):
        carry, h_t = _slstm_cell(wh, d, gx[:, t], carry)
        hs.append(h_t)
    return torch.stack(hs, dim=1), carry


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
    carry, h_new = _slstm_cell(params["wh"], d, gx_t, (c, n, m, h.to(x_t.dtype)))
    out = _slstm_out(params, cfg, h_new[:, None, :])
    c, n, m, hh = carry
    return out, (c, n, m, hh.to(torch.bfloat16))
