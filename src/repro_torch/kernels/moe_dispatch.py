"""The MoE dispatch on a card: the hand-written CUDA kernels of
``csrc/moe_dispatch.cu`` (a row-major rank of each (token, choice) pair,
then a gather of each expert slot's row) as the operator
``repro_torch::moe_dispatch``, and its backward, a gather-sum of each
source row's slots, as ``repro_torch::moe_dispatch_grad``.

Each operator has the parts of :mod:`repro_torch.kernels.attention`'s: a
CUDA implementation (the ctypes launch, built on first use by
:mod:`repro_torch.kernels.build`), a CPU implementation (the plain
versions, :func:`repro_torch.kernels.ref.ref_moe_dispatch` and
``ref_moe_dispatch_grad``) and a fake one (shapes and dtypes for a
``FakeTensorMode``). ``moe_dispatch`` also has an autograd formula
(``torch.library.register_autograd``): the source rows' gradient is
``moe_dispatch_grad`` of the buffer's. Neither has a FLOP formula: they
move bytes.

``models/moe.py::_dispatch`` calls :func:`moe_dispatch` for a CUDA tensor
and the plain ``ref_moe_dispatch`` for a CPU one, so a CPU tensor keeps the
twin of the JAX package's cumulative sum and ``.at[].add``; the operator's
CPU implementation lets the tests hold its autograd formula there.
:func:`moe_dispatch` refuses what the kernels do not take (a type other
than float32 or bfloat16, more than ``MAX_EXPERTS`` experts, a DTensor)
rather than give way to the plain route on the card.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ref
from repro_torch.kernels.attention import _DTYPES, _fake_only, _raise_if

__all__ = ["MAX_EXPERTS", "launches", "moe_dispatch"]

# Kernel launches per entry point (the rank and the gather count as one).
launches = {"moe_dispatch": 0, "moe_dispatch_grad": 0}

# Most experts the rank launch takes (one scanning thread an expert,
# ``kMaxExperts`` in csrc/moe_dispatch.cu).
MAX_EXPERTS = 256
# Fewest pairs a rank block takes: a warp's worth.
_RANK_MIN_PAIRS = 32


def _rank_blocks(n_pairs: int, n_sm: int) -> int:
    """Blocks of the rank launch: at most one an SM, each with at least
    ``_RANK_MIN_PAIRS`` pairs, and at least one."""
    return max(1, min(n_sm, -(-n_pairs // _RANK_MIN_PAIRS)))


def _outputs(src, n_pairs: int, cap: int, n_local: int) -> tuple:
    """Empty (experts, slots, keep, buffer, mine) of a dispatch."""
    idx = dict(dtype=torch.int64, device=src.device)
    flag = dict(dtype=torch.bool, device=src.device)
    return (src.new_empty(n_pairs, **idx), src.new_empty(n_pairs, **idx),
            src.new_empty(n_pairs, **flag), src.new_empty((n_local, cap, src.shape[-1])),
            src.new_empty(n_pairs, **flag))


def _dispatch_cuda(src, expert_idx, offset, n_experts: int, cap: int, first: int, n_local: int):
    from repro_torch.kernels.build import load

    ids = expert_idx.reshape(-1, expert_idx.shape[-1])  # a view of the router's [T, k]
    if ids.dtype != torch.int64:
        ids = ids.long()
    rows, d = src.shape
    TK = ids.numel()
    if src.stride(-1) != 1:
        src = src.contiguous()
    if offset is not None:
        offset = offset.to(device=src.device, dtype=torch.int64).contiguous()
    G = _rank_blocks(TK, torch.cuda.get_device_properties(src.device).multi_processor_count)
    experts, slots, keep, buf, mine = _outputs(src, TK, cap, n_local)
    # The look-back's words and the ticket, then the slot table and ranges.
    work = torch.empty(G * n_experts + 1 + (n_local * cap + 2 * n_local + 1) // 2,
                       dtype=torch.int64, device=src.device)
    size = src.element_size()
    _raise_if(load("moe_dispatch").moe_dispatch(
        src.data_ptr(), src.stride(0) * size, rows, d * size,
        ids.data_ptr(), ids.stride(0), ids.stride(1), ids.shape[1], TK,
        None if offset is None else offset.data_ptr(), n_experts, cap, first, n_local, G,
        experts.data_ptr(), slots.data_ptr(), keep.data_ptr(), mine.data_ptr(),
        buf.data_ptr(), work.data_ptr(), torch.cuda.current_stream(src.device).cuda_stream),
        "moe_dispatch")
    launches["moe_dispatch"] += 1
    return experts, slots, keep, buf, mine


def _dispatch_cpu(src, expert_idx, offset, n_experts: int, cap: int, first: int, n_local: int):
    experts, slots, keep, buf, mine = ref.ref_moe_dispatch(src, expert_idx, n_experts, cap,
                                                           offset, first, n_local)
    # An operator's outputs alias neither its inputs nor each other.
    return experts.clone(), slots, keep, buf, mine.clone()


def _dispatch_fake(src, expert_idx, offset, n_experts: int, cap: int, first: int, n_local: int):
    _fake_only(src, expert_idx, offset)
    return _outputs(src, expert_idx.numel(), cap, n_local)


def _grad_cuda(grad, experts, slots, mine, rows: int):
    from repro_torch.kernels.build import load

    grad = grad.contiguous()
    _, C, d = grad.shape
    out = torch.empty((rows, d), dtype=grad.dtype, device=grad.device)
    _raise_if(load("moe_dispatch").moe_dispatch_grad(
        _DTYPES[grad.dtype], grad.data_ptr(), experts.data_ptr(), slots.data_ptr(),
        mine.data_ptr(), out.data_ptr(), rows, experts.numel() // rows, C, d,
        torch.cuda.current_stream(grad.device).cuda_stream), "moe_dispatch_grad")
    launches["moe_dispatch_grad"] += 1
    return out


def _grad_fake(grad, experts, slots, mine, rows: int):
    _fake_only(grad, experts, slots, mine)
    return grad.new_empty((rows, grad.shape[-1]))


_LIB = torch.library.Library("repro_torch", "FRAGMENT")  # noqa: TOR901
_LIB.define("moe_dispatch(Tensor src, Tensor expert_idx, Tensor? offset, int n_experts, "
            "int cap, int first, int n_local) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.define("moe_dispatch_grad(Tensor grad, Tensor experts, Tensor slots, Tensor mine, "
            "int rows) -> Tensor")
_LIB.impl("moe_dispatch", _dispatch_cpu, "CPU")
_LIB.impl("moe_dispatch", _dispatch_cuda, "CUDA")
torch.library.register_fake("repro_torch::moe_dispatch", _dispatch_fake, lib=_LIB)
_LIB.impl("moe_dispatch_grad", ref.ref_moe_dispatch_grad, "CPU")
_LIB.impl("moe_dispatch_grad", _grad_cuda, "CUDA")
torch.library.register_fake("repro_torch::moe_dispatch_grad", _grad_fake, lib=_LIB)

_OPS = torch.ops.repro_torch


def _setup_context(ctx, inputs, output) -> None:
    experts, slots, _, _, mine = output
    ctx.save_for_backward(experts, slots, mine)
    ctx.rows = inputs[0].shape[0]


def _backward(ctx, _experts, _slots, _keep, grad, _mine):
    experts, slots, mine = ctx.saved_tensors
    g = None if grad is None else _OPS.moe_dispatch_grad(grad, experts, slots, mine, ctx.rows)
    return g, None, None, None, None, None, None


torch.library.register_autograd("repro_torch::moe_dispatch", _backward,
                                setup_context=_setup_context, lib=_LIB)


def moe_dispatch(src: torch.Tensor, expert_idx: torch.Tensor, n_experts: int, cap: int,
                 offset: torch.Tensor | None = None, first: int = 0,
                 n_local: int | None = None) -> tuple:
    """(experts [TK], slots [TK], keep [TK], buffer [n_local, cap, d], mine
    [TK]) of the TK (token, choice) pairs of ``expert_idx`` [T, k], pair p
    reading row ``p // (TK // rows)`` of ``src`` [rows, d] (token rows, or
    one row a pair): the values of
    :func:`repro_torch.kernels.ref.ref_moe_dispatch`, whose docstring says
    what each is, with every buffer cell written once (a kept row copied,
    zeros elsewhere)."""
    n_local = n_local or n_experts
    if isinstance(src, DTensor) or src.dtype not in _DTYPES or n_experts > MAX_EXPERTS:
        raise ValueError(f"the dispatch kernels take local float32 or bfloat16 rows and at "
                         f"most {MAX_EXPERTS} experts, got a {type(src).__name__} of "
                         f"{src.dtype} and {n_experts} experts")
    if src.dim() != 2 or src.shape[0] == 0 or expert_idx.numel() % src.shape[0]:
        raise ValueError(f"src must be [rows, d] with rows dividing the {expert_idx.numel()} "
                         f"pairs, got {tuple(src.shape)}")
    if not 0 <= first <= n_experts - n_local:
        raise ValueError(f"experts {first}..{first + n_local - 1} outside 0..{n_experts - 1}")
    return tuple(_OPS.moe_dispatch(src, expert_idx, offset, n_experts, cap, first, n_local))
