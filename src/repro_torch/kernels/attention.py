"""Flash (prefill and training) and decode attention: wrappers of the
hand-written CUDA kernels in ``csrc/flash_attention.cu`` (forward, with an
optional log-sum-exp output), ``csrc/flash_attention_bwd.cu`` (backward)
and ``csrc/decode_attention.cu``.

Each kernel is an operator of the ``repro_torch`` namespace, defined with
the low-level ``torch.library.Library`` ``define`` / ``impl`` (the
``custom_op`` decorator adds a Python layer to every call, and the decode
step calls the decode operator once a layer; see PERF.md's findings for the
host cost of both). An operator has four parts:

  * a CUDA implementation, the ctypes launch of the kernel (built on first
    use by :mod:`repro_torch.kernels.build`), or an error;
  * a CPU implementation, the plain PyTorch version in
    :mod:`repro_torch.kernels.ref`;
  * a fake implementation (``torch.library.register_fake``), which gives
    the output shapes and dtypes only, for tensors of a ``FakeTensorMode``
    (the dry run); it refuses a real tensor, so a ``meta`` tensor raises;
  * a FLOP formula (``torch.utils.flop_counter.register_flop_formula``):
    :func:`flash_flops`, :func:`backward_flops` and :func:`decode_flops`,
    the counts behind the kernels' bounds, so that ``FlopCounterMode`` and
    :mod:`repro_torch.launch.op_analysis` count one op where the card
    launches one kernel.

The dispatcher picks the implementation by the tensors' device; there is
no fallback from one to another, and any other device raises. The Python
wrappers below keep the checks of the JAX package's signatures and call
the operators. ``launches`` counts kernel launches per entry point and is
touched only where a kernel is launched. A DTensor is refused: it has no
storage of its own for the kernels' pointers, so under a mesh the callers
pass each rank's local shard (``models/flash.py``, ``models/layers.py``).
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref

__all__ = [
    "flash_attention",
    "flash_attention_bwd",
    "flash_bwd_delta",
    "flash_bwd_dkdv",
    "flash_bwd_dq",
    "decode_attention",
    "decode_splits",
    "flash_flops",
    "backward_flops",
    "decode_flops",
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


# --------------------------------------------------------------------------
# Operation counts (the FLOP formulas of the operators, and the operations
# behind the kernels' bounds in chip_smoke.py)
# --------------------------------------------------------------------------

def _shape(t) -> tuple:
    return tuple(t.shape) if hasattr(t, "shape") else tuple(t)


def _pairs(S: int, T: int, causal: bool) -> int:
    """(query, key) pairs: query s attends to keys t <= s when causal (the
    triangle, clipped at T), to all T otherwise."""
    if not causal:
        return S * T
    if S <= T:
        return S * (S + 1) // 2
    return T * (T + 1) // 2 + (S - T) * T


def flash_flops(q, k, causal: bool) -> int:
    """4 * H * D flops per (query, key) pair, the causal triangle only
    (``q`` [B, S, H, D], ``k`` [B, T, KV, D]: tensors or shapes)."""
    B, S, H, D = _shape(q)
    return 4 * B * H * D * _pairs(S, _shape(k)[1], causal)


def backward_flops(q, k, causal: bool) -> dict:
    """Operations of the forward with lse, of each backward kernel and of
    the backward pass: products of 2 D flops per (query row, key) pair and
    head (the causal triangle only); the forward needs 2 products, dkdv 4
    (S, dP, dV, dK), dq 3 (S, dP, dQ), the pass 5 (2.5x the forward's);
    delta 2 D flops a row."""
    B, S, H, D = _shape(q)
    product = flash_flops(q, k, causal) // 2
    return {"flash_attention_lse": 2 * product, "flash_bwd_delta": 2 * B * S * H * D,
            "flash_bwd_dkdv": 4 * product, "flash_bwd_dq": 3 * product,
            "backward_pass": 5 * product}


def decode_flops(q, k, lens=None, len_all: int = 0) -> int:
    """4 * H * D flops per (batch row, cache row) that the row attends to:
    ``min(len_all, T)`` rows of an int length (all T rows when it is <= 0,
    as the kernel masks every row and attends uniformly). A ``[B]`` length
    tensor counts all T rows of every batch row: a fake tensor holds no
    lengths to read, and the count must not differ between the card and
    the dry run's fake trace (the main path passes an int)."""
    B, H, D = _shape(q)
    T = _shape(k)[1]
    rows = T if lens is not None or len_all <= 0 else min(int(len_all), T)
    return 4 * B * H * D * rows


# --------------------------------------------------------------------------
# The operators: CUDA (the kernels), CPU (the plain versions), fake, FLOPs
# --------------------------------------------------------------------------

_LIB = torch.library.Library("repro_torch", "DEF")  # noqa: TOR901
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor")
_LIB.define("flash_fwd_lse(Tensor q, Tensor k, Tensor v, bool causal) -> (Tensor, Tensor)")
_LIB.define("flash_bwd_delta(Tensor o, Tensor do) -> Tensor")
_LIB.define("flash_bwd_dkdv(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, "
            "Tensor delta, bool causal) -> (Tensor, Tensor)")
_LIB.define("flash_bwd_dq(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, "
            "Tensor delta, bool causal) -> Tensor")
_LIB.define("decode_attention(Tensor q, Tensor k, Tensor v, Tensor? lens, int len_all) -> Tensor")

_OPS = torch.ops.repro_torch


def _register(name: str, cpu, cuda, fake, flops) -> None:
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    register_flop_formula(getattr(_OPS, name))(flops)


def _fake_only(*tensors) -> None:
    """The fake implementations serve a ``FakeTensorMode`` only: a real
    tensor that reaches one (a ``meta`` tensor) raises."""
    if not all(isinstance(t, FakeTensor) for t in tensors if t is not None):
        raise ValueError("the repro_torch operators take cpu, cuda or fake tensors, "
                         f"got {[str(t.device) for t in tensors if t is not None]}")


def _flash_cuda(q, k, v, causal: bool, return_lse: bool):
    from repro_torch.kernels.build import load

    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
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


def _flash_fake(q, k, v, causal: bool):
    _fake_only(q, k, v)
    return q.new_empty(q.shape)


def _flash_lse_fake(q, k, v, causal: bool):
    _fake_only(q, k, v)
    return q.new_empty(q.shape), q.new_empty(q.shape[:3], dtype=torch.float32)


_register("flash_fwd",
          lambda q, k, v, causal: ref.ref_flash_attention(q, k, v, causal),
          lambda q, k, v, causal: _flash_cuda(q, k, v, causal, False),
          _flash_fake,
          lambda q, k, v, causal, out_shape=None: flash_flops(q, k, causal))
_register("flash_fwd_lse",
          lambda q, k, v, causal: ref.ref_flash_attention(q, k, v, causal, return_lse=True),
          lambda q, k, v, causal: _flash_cuda(q, k, v, causal, True),
          _flash_lse_fake,
          lambda q, k, v, causal, out_shape=None: backward_flops(q, k, causal)[
              "flash_attention_lse"])


def _delta_cuda(o, do):
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


def _delta_fake(o, do):
    _fake_only(o, do)
    return o.new_empty(o.shape[:3], dtype=torch.float32)


_register("flash_bwd_delta", ref.ref_flash_bwd_delta, _delta_cuda, _delta_fake,
          lambda o, do, out_shape=None: 2 * math.prod(_shape(o)))


def _dkdv_cuda(q, k, v, do, lse, delta, causal: bool):
    from repro_torch.kernels.build import load

    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
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


def _dkdv_fake(q, k, v, do, lse, delta, causal: bool):
    _fake_only(q, k, v, do, lse, delta)
    return k.new_empty(k.shape), v.new_empty(v.shape)


_register("flash_bwd_dkdv", ref.ref_flash_bwd_dkdv, _dkdv_cuda, _dkdv_fake,
          lambda q, k, v, do, lse, delta, causal, out_shape=None: backward_flops(
              q, k, causal)["flash_bwd_dkdv"])


def _dq_cuda(q, k, v, do, lse, delta, causal: bool):
    from repro_torch.kernels.build import load

    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
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


def _dq_fake(q, k, v, do, lse, delta, causal: bool):
    _fake_only(q, k, v, do, lse, delta)
    return q.new_empty(q.shape)


_register("flash_bwd_dq", ref.ref_flash_bwd_dq, _dq_cuda, _dq_fake,
          lambda q, k, v, do, lse, delta, causal, out_shape=None: backward_flops(
              q, k, causal)["flash_bwd_dq"])


# --------------------------------------------------------------------------
# The wrappers: the JAX package's signatures and checks, then the operators
# --------------------------------------------------------------------------

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
    _flash_shapes(q, k, v)
    if return_lse:
        return tuple(_OPS.flash_fwd_lse(q, k, v, bool(causal)))
    return _OPS.flash_fwd(q, k, v, bool(causal))


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
    return _OPS.flash_bwd_delta(o, do)


def flash_bwd_dkdv(q, k, v, do, lse, delta, causal: bool = True):
    """(dk, dv) [B, T, KV, D] in k's and v's types, the G query heads of
    each kv head summed (kernel (b)); ``lse`` and ``delta`` are float32
    [B, S, H]."""
    _bwd_inputs(q, k, v, do, lse, delta)
    return tuple(_OPS.flash_bwd_dkdv(q, k, v, do, lse, delta, bool(causal)))


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True) -> torch.Tensor:
    """dq [B, S, H, D] in q's type (kernel (c)); ``lse`` and ``delta`` are
    float32 [B, S, H]."""
    _bwd_inputs(q, k, v, do, lse, delta)
    return _OPS.flash_bwd_dq(q, k, v, do, lse, delta, bool(causal))


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


def _decode_cuda(q, k, v, lens, len_all: int):
    from repro_torch.kernels.build import load

    B, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
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


def _decode_fake(q, k, v, lens, len_all: int):
    _fake_only(q, k, v, lens)
    return q.new_empty(q.shape)


_register("decode_attention",
          lambda q, k, v, lens, len_all: ref.ref_decode_attention(
              q, k, v, len_all if lens is None else lens),
          _decode_cuda, _decode_fake,
          lambda q, k, v, lens, len_all, out_shape=None: decode_flops(q, k, lens, len_all))


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
    return _OPS.decode_attention(q, k, v, lens, len_all)
