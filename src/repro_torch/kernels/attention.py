"""Flash (prefill) and decode attention: wrappers of the hand-written CUDA
kernels in ``csrc/flash_attention.cu`` and ``csrc/decode_attention.cu``.

A CUDA tensor goes to the kernel (built on first use by
:mod:`repro_torch.kernels.build`) or raises; a CPU tensor goes to the
plain PyTorch version in :mod:`repro_torch.kernels.ref`. There is no
fallback from one to the other. ``launches`` counts kernel launches per
entry point and is touched nowhere else.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref

__all__ = [
    "flash_attention",
    "decode_attention",
    "decode_splits",
    "launches",
    "MAX_HEAD_DIM",
]

# Kernel launches per entry point (plain integers; the CPU route adds 0).
launches = {"flash_attention": 0, "decode_attention": 0}

# Largest head_dim the kernels take (their tiles are sized for it).
MAX_HEAD_DIM = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(name: str, t, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
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


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    causal: bool = True,
    block_q: int = 128,
    block_kv: int = 128,
) -> torch.Tensor:
    """GQA attention forward pass, [B, S, H, D] in q's type: query s
    attends to keys t <= s when ``causal``. Any S and T. ``block_q`` and
    ``block_kv`` are accepted for signature parity with the JAX package;
    the CUDA kernel sizes its own tiles."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, 4)
    _same(q, k, v)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, KV, D) or tuple(v.shape) != (B, T, KV, D):
        raise ValueError(f"k and v must be [B, T, KV, D] = {(B, T, KV, D)}")
    if min(B, S, T, H, KV, D) <= 0 or H % KV:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.device.type == "cpu":
        return ref.ref_flash_attention(q, k, v, causal)
    from repro_torch.kernels.build import load

    _kernel_layout(16, q, k, v)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    err = load("flash_attention").flash_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), _strides(q, k, v, out), B, S, T, H, KV, D,
        int(bool(causal)), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_if(err, "flash_attention_fwd")
    launches["flash_attention"] += 1
    return out


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
