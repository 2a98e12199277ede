"""Flash (prefill and training) and decode attention: wrappers of the
hand-written CUDA kernels in ``csrc/flash_attention.cu`` (forward, with an
optional log-sum-exp output), ``csrc/flash_attention_bwd.cu`` (backward)
and ``csrc/decode_attention.cu``.

A CUDA tensor goes to the kernel (built on first use by
:mod:`repro_torch.kernels.build`) or raises; a CPU tensor goes to the
plain PyTorch version in :mod:`repro_torch.kernels.ref`. There is no
fallback from one to the other. ``launches`` counts kernel launches per
entry point and is touched nowhere else. A DTensor is refused: it has no
storage of its own for the kernels' pointers, so under a mesh the callers
pass each rank's local shard (``models/flash.py``, ``models/layers.py``).
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ref

__all__ = [
    "flash_attention",
    "flash_attention_bwd",
    "flash_bwd_delta",
    "flash_bwd_dkdv",
    "flash_bwd_dq",
    "decode_attention",
    "decode_splits",
    "launches",
    "MAX_HEAD_DIM",
]

# Kernel launches per entry point (plain integers; the CPU route adds 0).
# The flash forward counts under "flash_attention" on the serving route and
# under "flash_attention_lse" when it also writes the log-sum-exp (training).
launches = {"flash_attention": 0, "flash_attention_lse": 0, "decode_attention": 0,
            "flash_bwd_delta": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}

# Largest head_dim the kernels take (their tiles are sized for it).
MAX_HEAD_DIM = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(name: str, t, ndim: int) -> None:
    if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
        raise TypeError(f"{name} must be a torch.Tensor (a DTensor's local shard under a mesh)")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def _same(q: torch.Tensor, *others: torch.Tensor) -> None:
    for t in others:
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"mixed dtypes {q.dtype} and {t.dtype}")


def _kernel_layout(step: int, *tensors: torch.Tensor) -> None:
    """What the kernels read: a supported dtype, a contiguous last
    dimension, 16-byte aligned rows (so every row is one run of 16-byte
    loads), and a head_dim that is a multiple of ``step``."""
    D = tensors[0].shape[-1]
    if tensors[0].dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {tensors[0].dtype}")
    if D % step or D > MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim must be a multiple of {step} and at most {MAX_HEAD_DIM}, got {D}"
        )
    for t in tensors:
        size = t.element_size()
        if t.stride(-1) != 1:
            raise ValueError("the last dimension must be contiguous")
        if t.data_ptr() % 16 or any(s * size % 16 for s in t.stride()[:-1]):
            raise ValueError("rows must be 16-byte aligned")


def _strides(*tensors: torch.Tensor):
    vals = [s for t in tensors for s in t.stride()[:-1]]
    return (ctypes.c_int64 * len(vals))(*vals)


def _raise_if(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError {err}")


def _flash_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """(B, S, T, H, KV, D) of a flash call, after checking q, k, v."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, 4)
    _same(q, k, v)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, KV, D) or tuple(v.shape) != (B, T, KV, D):
        raise ValueError(f"k and v must be [B, T, KV, D] = {(B, T, KV, D)}")
    if min(B, S, T, H, KV, D) <= 0 or H % KV:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    return B, S, T, H, KV, D


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    causal: bool = True,
    block_q: int = 128,
    block_kv: int = 128,
    return_lse: bool = False,
):
    """GQA attention forward pass, [B, S, H, D] in q's type: query s
    attends to keys t <= s when ``causal``. Any S and T. ``block_q`` and
    ``block_kv`` are accepted for signature parity with the JAX package;
    the CUDA kernel sizes its own tiles. With ``return_lse`` the result is
    ``(out, lse)``, lse [B, S, H] float32 being each row's log-sum-exp of
    the scaled scores (the backward pass's residual); without it the
    kernel writes no lse."""
    B, S, T, H, KV, D = _flash_shapes(q, k, v)
    if q.device.type == "cpu":
        return ref.ref_flash_attention(q, k, v, causal, return_lse=return_lse)
    from repro_torch.kernels.build import load

    _kernel_layout(16, q, k, v)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device) if return_lse else None
    err = load("flash_attention").flash_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        _strides(q, k, v, out), B, S, T, H, KV, D,
        int(bool(causal)), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_if(err, "flash_attention_fwd")
    launches["flash_attention_lse" if return_lse else "flash_attention"] += 1
    return (out, lse) if return_lse else out


def _bwd_inputs(q, k, v, do, lse, delta=None) -> tuple:
    """(B, S, T, H, KV, D) after checking the backward kernels' inputs."""
    B, S, T, H, KV, D = _flash_shapes(q, k, v)
    _check("do", do, 4)
    _same(q, do)
    if tuple(do.shape) != (B, S, H, D):
        raise ValueError(f"do must be [B, S, H, D] = {(B, S, H, D)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (tuple(t.shape) != (B, S, H) or t.dtype != torch.float32
                              or t.device != q.device):
            raise ValueError(f"{name} must be float32 [B, S, H] = {(B, S, H)} on {q.device}")
    return B, S, T, H, KV, D


def flash_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta [B, S, H] float32 = rowsum(do * o), one warp a row on a card
    (kernel (a) of ``csrc/flash_attention_bwd.cu``)."""
    for name, t in (("o", o), ("do", do)):
        _check(name, t, 4)
    _same(o, do)
    if o.shape != do.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} differ")
    if o.device.type == "cpu":
        return ref.ref_flash_bwd_delta(o, do)
    from repro_torch.kernels.build import load

    _kernel_layout(16, o, do)
    B, S, H, D = o.shape
    delta = torch.empty((B, S, H), dtype=torch.float32, device=o.device)
    _raise_if(load("flash_attention_bwd").flash_bwd_delta(
        _DTYPES[o.dtype], o.data_ptr(), do.data_ptr(), delta.data_ptr(),
        _strides(o, o, o, o, do), B, S, H, D,
        torch.cuda.current_stream(o.device).cuda_stream), "flash_bwd_delta")
    launches["flash_bwd_delta"] += 1
    return delta


def flash_bwd_dkdv(q, k, v, do, lse, delta, causal: bool = True):
    """(dk, dv) [B, T, KV, D] in k's and v's types, the G query heads of
    each kv head summed (kernel (b)); ``lse`` and ``delta`` are float32
    [B, S, H]."""
    B, S, T, H, KV, D = _bwd_inputs(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return ref.ref_flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
    from repro_torch.kernels.build import load

    _kernel_layout(16, q, k, v, do)
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.empty((B, T, KV, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, T, KV, D), dtype=v.dtype, device=q.device)
    _raise_if(load("flash_attention_bwd").flash_bwd_dkdv(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do, do), B, S, T, H, KV, D, int(bool(causal)),
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream),
        "flash_bwd_dkdv")
    launches["flash_bwd_dkdv"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True) -> torch.Tensor:
    """dq [B, S, H, D] in q's type (kernel (c)); ``lse`` and ``delta`` are
    float32 [B, S, H]."""
    B, S, T, H, KV, D = _bwd_inputs(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return ref.ref_flash_bwd_dq(q, k, v, do, lse, delta, causal)
    from repro_torch.kernels.build import load

    _kernel_layout(16, q, k, v, do)
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    _raise_if(load("flash_attention_bwd").flash_bwd_dq(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _strides(q, k, v, do, do),
        B, S, T, H, KV, D, int(bool(causal)), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream), "flash_bwd_dq")
    launches["flash_bwd_dq"] += 1
    return dq


def flash_attention_bwd(
    q: torch.Tensor,    # [B, S, H, D]
    k: torch.Tensor,    # [B, T, KV, D]
    v: torch.Tensor,    # [B, T, KV, D]
    o: torch.Tensor,    # [B, S, H, D]: the forward's output
    lse: torch.Tensor,  # [B, S, H] float32: the forward's log-sum-exp
    do: torch.Tensor,   # [B, S, H, D]: the output's gradient
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention`, each in its input's type,
    dk and dv summed over the G query heads of each kv head: the three
    backward kernels in turn (delta, dk and dv, dq), no atomics."""
    B, S, T, H, KV, D = _bwd_inputs(q, k, v, do, lse)
    if tuple(o.shape) != (B, S, H, D):
        raise ValueError(f"o must be [B, S, H, D] = {(B, S, H, D)}")
    delta = flash_bwd_delta(o, do)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
    return flash_bwd_dq(q, k, v, do, lse, delta, causal), dk, dv


# The decode kernel's split plan (csrc/decode_attention.cu, points 1-2).
# A block holds a 48 KB ring and at most 128 registers a thread (up to four
# group heads), so four fit an SM; the plan asks for at most two full waves
# of blocks, and no split under 64 rows.
DECODE_BLOCKS_PER_SM = 4
DECODE_WAVES = 2
DECODE_MIN_SPLIT_ROWS = 64

# (dtype, device, shapes and strides of q, k, v) -> (S, ctypes strides):
# what a decode call checks and derives from its layout, once per layout.
_decode_plans: dict[tuple, tuple] = {}


def decode_splits(B: int, KV: int, T: int, n_sm: int) -> int:
    """Splits S of the cache per (batch row, kv head): the most that keep
    ``B * KV * S`` within ``DECODE_WAVES`` full waves of blocks on ``n_sm``
    SMs (a few blocks past a full wave would run alone, after the rest),
    with no split covering fewer than ``DECODE_MIN_SPLIT_ROWS`` rows of T;
    at least 1."""
    want = DECODE_WAVES * DECODE_BLOCKS_PER_SM * n_sm // (B * KV)
    return max(1, min(want, T // DECODE_MIN_SPLIT_ROWS))


def _decode_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The split count and the kernel's stride array for this call's layout,
    checked once per layout; later calls check only the data pointers."""
    key = (q.dtype, q.device, q.shape, q.stride(), k.shape, k.stride(), v.stride())
    plan = _decode_plans.get(key)
    if plan is None:
        _kernel_layout(8, q, k, v)
        if len(_decode_plans) >= 256:
            _decode_plans.clear()
        B, T, KV = q.shape[0], k.shape[1], k.shape[2]
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        plan = _decode_plans[key] = (decode_splits(B, KV, T, n_sm), _strides(q, k, v))
    elif (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("rows must be 16-byte aligned")
    return plan


def decode_attention(
    q: torch.Tensor,  # [B, H, D]: one query token per batch row
    k: torch.Tensor,  # [B, T, KV, D] cache
    v: torch.Tensor,  # [B, T, KV, D] cache
    kv_len,           # int, [] or [B] integer tensor: valid cache rows
    block_kv: int = 512,
) -> torch.Tensor:
    """[B, H, D] in q's type: each row's query against its first
    ``kv_len[b]`` cache rows. ``block_kv`` is accepted for signature
    parity with the JAX package; the CUDA kernel sizes its own tiles and
    takes its split count from :func:`decode_splits`. An int ``kv_len``
    reaches the kernel by value."""
    _check("q", q, 3)
    _check("k", k, 4)
    _check("v", v, 4)
    _same(q, k, v)
    B, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, KV, D) or tuple(v.shape) != (B, T, KV, D):
        raise ValueError(f"k and v must be [B, T, KV, D] = {(B, T, KV, D)}")
    if min(B, T, H, KV, D) <= 0 or H % KV:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    lens, len_all = None, 0
    if isinstance(kv_len, torch.Tensor):
        if kv_len.dim() > 1 or (kv_len.dim() == 1 and kv_len.shape[0] not in (1, B)):
            raise ValueError(f"kv_len must be [] or [B], got {tuple(kv_len.shape)}")
        if kv_len.device != q.device:
            raise ValueError(f"kv_len is on {kv_len.device}, expected {q.device}")
        lens = kv_len
        if lens.dtype != torch.int32 or lens.shape != (B,) or not lens.is_contiguous():
            lens = lens.to(torch.int32).reshape(-1).expand(B).contiguous()
    else:
        # Clamped into int32 without changing the result: <= 0 masks every
        # row, >= T takes every row.
        len_all = max(-1, min(int(kv_len), T))
    if q.device.type == "cpu":
        return ref.ref_decode_attention(q, k, v, len_all if lens is None else lens)
    from repro_torch.kernels.build import load

    S, strides = _decode_plan(q, k, v)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    part = torch.empty((B, H, S, D + 2), dtype=torch.float32, device=q.device)
    err = load("decode_attention").decode_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), len_all, out.data_ptr(),
        part.data_ptr(), strides, B, T, H, KV, D, S, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_if(err, "decode_attention_fwd")
    launches["decode_attention"] += 1
    return out
