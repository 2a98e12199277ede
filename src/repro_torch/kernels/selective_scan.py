"""Mamba-1's selective scan on a card: the hand-written CUDA kernel of
``csrc/selective_scan.cu`` (the softplus of dt, the discretisation, the
scan over time, ``C . s``, the ``D`` skip and the ``silu(z)`` gate in one
launch) as the operator ``repro_torch::selective_scan``.

The operator has the parts of :mod:`repro_torch.kernels.attention`'s: a
CUDA implementation (the ctypes launch, built on first use by
:mod:`repro_torch.kernels.build`, or an error), a CPU implementation (the
plain loop, :func:`repro_torch.kernels.ref.ref_selective_scan`), a fake one
(shapes and dtypes for a ``FakeTensorMode``) and a FLOP formula
(:func:`scan_flops`). It has no autograd formula: the kernel is forward
only, and :func:`selective_scan` raises when an input asks for a gradient
(without it, autograd would pass no gradient through the operator, with a
warning), so training a Mamba-1 mixer raises on either device.

``models/ssm.py::mamba1_forward`` calls :func:`selective_scan` on either
device. For a CUDA tensor the kernel runs or the call raises: no type but
float32 and bfloat16, N 16, d_inner a multiple of 64, channels contiguous
and 16-byte aligned rows (the wrapper copies B and C, which are small, to
contiguous rows itself).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref
from repro_torch.kernels.attention import _DTYPES, _fake_only, _raise_if, _strides

__all__ = ["N_STATE", "CHANNELS_A_BLOCK", "launches", "scan_flops", "selective_scan"]

# Kernel launches (plain integer; the CPU route adds 0).
launches = {"selective_scan": 0}

# The states a channel and the channels a block of the kernel (kN, kC in
# csrc/selective_scan.cu).
N_STATE = 16
CHANNELS_A_BLOCK = 64


def scan_flops(x, Bm) -> int:
    """6 flops a (token, channel, state): the decay's product, the state's
    two products and add, and ``C . s``'s product and add; the
    exponentials, the softplus, the skip and the gate are not counted."""
    B, S, di = _shape(x)
    return 6 * B * S * di * _shape(Bm)[-1]


def _shape(t) -> tuple:
    return tuple(t.shape) if hasattr(t, "shape") else tuple(t)


def _scan_cuda(x, dt, z, Bm, Cm, A_log, D, dt_bias):
    from repro_torch.kernels.build import load

    B, S, di = x.shape
    N = Bm.shape[-1]
    if x.dtype not in _DTYPES or N != N_STATE or di % CHANNELS_A_BLOCK:
        raise ValueError(f"the selective-scan kernel takes float32 or bfloat16, N "
                         f"{N_STATE} and d_inner a multiple of {CHANNELS_A_BLOCK}, got "
                         f"{x.dtype}, N {N}, d_inner {di}")
    for name, t in (("x", x), ("dt", dt), ("z", z)):
        size = t.element_size()
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s * size % 16 for s in t.stride()[:2]):
            raise ValueError(f"{name} must have contiguous channels and 16-byte aligned rows")
    Bm, Cm = Bm.contiguous(), Cm.contiguous()
    A_log, D, dt_bias = (t.to(torch.float32).contiguous() for t in (A_log, D, dt_bias))
    out = torch.empty((B, S, di), dtype=x.dtype, device=x.device)
    _raise_if(load("selective_scan").selective_scan(
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), z.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), A_log.data_ptr(), D.data_ptr(), dt_bias.data_ptr(), out.data_ptr(),
        _strides(x, dt, z, out), B, S, di, N, torch.cuda.current_stream(x.device).cuda_stream),
        "selective_scan")
    launches["selective_scan"] += 1
    return out


def _scan_fake(x, dt, z, Bm, Cm, A_log, D, dt_bias):
    _fake_only(x, dt, z, Bm, Cm, A_log, D, dt_bias)
    return x.new_empty(x.shape)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")  # noqa: TOR901
_LIB.define("selective_scan(Tensor x, Tensor dt, Tensor z, Tensor Bm, Tensor Cm, "
            "Tensor A_log, Tensor D, Tensor dt_bias) -> Tensor")
_LIB.impl("selective_scan", ref.ref_selective_scan, "CPU")
_LIB.impl("selective_scan", _scan_cuda, "CUDA")
torch.library.register_fake("repro_torch::selective_scan", _scan_fake, lib=_LIB)
register_flop_formula(torch.ops.repro_torch.selective_scan)(
    lambda x, dt, z, Bm, Cm, A_log, D, dt_bias, out_shape=None: scan_flops(x, Bm))


def selective_scan(x: torch.Tensor, dt: torch.Tensor, z: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                   dt_bias: torch.Tensor) -> torch.Tensor:
    """``y * silu(z)`` [B, S, d_inner] in x's type, y Mamba-1's selective
    scan from a zero state (:func:`repro_torch.kernels.ref.ref_selective_scan`
    says what each input is)."""
    if any(isinstance(t, DTensor) for t in (x, dt, z, Bm, Cm)):
        raise NotImplementedError("the selective scan takes local tensors: "
                                  "Mamba-1 has no mesh route")
    B, S, di = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, S, di) or tuple(z.shape) != (B, S, di)
            or tuple(Bm.shape) != (B, S, N) or tuple(Cm.shape) != (B, S, N)
            or tuple(A_log.shape) != (di, N) or tuple(D.shape) != (di,)
            or tuple(dt_bias.shape) != (di,)):
        raise ValueError("selective_scan wants x, dt, z [B, S, di], Bm, Cm [B, S, N], "
                         f"A_log [di, N], D and dt_bias [di]; got x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, z {tuple(z.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}, A_log {tuple(A_log.shape)}")
    if len({t.dtype for t in (x, dt, z, Bm, Cm)}) != 1:
        raise TypeError("x, dt, z, Bm and Cm must share one type")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, z, Bm, Cm, A_log, D, dt_bias)):
        raise NotImplementedError("the selective scan is forward only: it has no backward, "
                                  "so a Mamba-1 mixer cannot train")
    return torch.ops.repro_torch.selective_scan(x, dt, z, Bm, Cm, A_log, D, dt_bias)
