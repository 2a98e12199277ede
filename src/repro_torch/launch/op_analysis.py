"""Per-device op counts of an eager step (counterpart of
``repro.launch.hlo_analysis``, the JAX package's post-SPMD HLO analyzer).

The JAX package compiles a step for its production mesh and parses the
per-partition HLO, because XLA's own ``cost_analysis`` counts a while-loop
body once. PyTorch has no HLO and no compile step to lower into: here the
step itself runs, eagerly, under a ``TorchDispatchMode`` that counts every
op this rank runs. On a fake world (``launch.mesh.fake_world``) under a
``FakeTensorMode`` the tensors hold no data and nothing is computed, so a
step at the published widths over 256 or 512 ranks runs on one host.

Counts are PER DEVICE, as the post-SPMD HLO's are. A DTensor op is seen
twice by a dispatch mode: once at the global shapes, before DTensor
dispatches it, and then as the local op on this rank's shards. The counter
returns ``NotImplemented`` on the first, which lets DTensor run, and counts
the second: the local op that the device runs (a [16, 256] @ [256, 4096]
matmul on a 16 x 16 mesh, not the [256, 4096] @ [4096, 4096] one).
DTensor's planning runs ops of its own (its shape inference on tensors of
the global shapes, a strided shard's index arithmetic); those are not
counted, and run outside the caller's ``FakeTensorMode`` (:func:`_planning`).

Conventions, those of ``hlo_analysis.py``:

  * flops: the registered FLOP formulas of ``torch.utils.flop_counter``:
    aten's own for ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and convolution,
    and :mod:`repro_torch.kernels.attention`'s for the port's kernel
    operators (one op where the card launches one kernel);
  * collective_bytes: the output bytes of each ``_c10d_functional`` op,
    under HLO's names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
    ``all-to-all``); ``wait_tensor`` is trivial;
  * hbm_bytes: a matmul counts its output plus both operands; a gather or
    an index counts twice its output (it reads only what it takes); a
    kernel operator counts its inputs read once and its outputs written
    once (what the kernel moves); any other op that is not trivial counts
    twice its output;
  * trivial (no bytes): views, ``detach``, ``empty``, ``t``, a ``_to_copy``
    that changes nothing, ``wait_tensor``.

What eager counting cannot match:

  * there is no fusion: every elementwise op's output counts, where XLA's
    fusions keep most of them in registers, so ``hbm_bytes`` is an upper
    proxy beside the reference's;
  * DTensor chooses its own collectives op by op (its redistributions),
    not XLA's SPMD partitioner, which plans the whole program;
  * there is no overlap and no schedule: the roofline terms add up work,
    they do not time it;
  * loops run: a Python loop (micro-batches, layers, loss chunks) is
    counted once per iteration because it runs once per iteration, so the
    trip-count logic of ``hlo_analysis.py`` has no counterpart; the one
    exception is the sLSTM's time loop, whose steps the dry run's trace
    takes once and counts S times (:func:`repeated`;
    ``launch.dryrun.traced_loops``), since tracing every step takes ~10 ms
    of host time a step (70 minutes for one xlstm-350m prefill cell).

``xla_cost_analysis`` has no compiler to ask. Its counterpart is
:func:`flop_counter_total`, ``FlopCounterMode``'s own total, which on
DTensors counts the global op and so the sum over every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

__all__ = ["OpCost", "analyze_ops", "flop_counter_total", "in_planning", "repeated",
           "COLLECTIVES"]

aten = torch.ops.aten

# _c10d_functional op -> HLO's collective name.
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_MATMULS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
_MATMUL_OPERANDS = {aten.mm: (0, 1), aten.bmm: (0, 1), aten.addmm: (1, 2), aten.baddbmm: (1, 2)}
_TRIVIAL = {
    aten.detach, aten.empty, aten.empty_strided, aten.empty_like, aten.t,
    aten.lift_fresh, aten.alias,
}


@dataclasses.dataclass
class OpCost:
    """Per-device counts: ``flops``, ``hbm_bytes``, ``collective_bytes`` by
    HLO's collective names; and for each of the port's kernel operators
    (``repro_torch::*``) its calls (``kernel_calls``) and the part of
    ``flops`` its formula gave (``kernel_flops``)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_calls: dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_flops: dict[str, float] = dataclasses.field(default_factory=dict)

    def __iadd__(self, other: "OpCost") -> "OpCost":
        self.flops += other.flops
        self.hbm_bytes += other.hbm_bytes
        for key in ("collective_bytes", "kernel_calls", "kernel_flops"):
            for k, v in getattr(other, key).items():
                _add(getattr(self, key), k, v)
        return self

    def scaled(self, m: float) -> "OpCost":
        return OpCost(
            flops=self.flops * m,
            hbm_bytes=self.hbm_bytes * m,
            **{key: {k: v * m for k, v in getattr(self, key).items()}
               for key in ("collective_bytes", "kernel_calls", "kernel_flops")},
        )

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


_TLS = threading.local()


@contextlib.contextmanager
def _not_the_ranks_work():
    """Ops in this span are DTensor's planning, not the rank's work: they
    are not counted, and they run outside the caller's ``FakeTensorMode``
    (DTensor then runs its shape inference under a fake mode of its own,
    which a ``MemTracker`` entered under the caller's mode does not count
    either, and its planners' index arithmetic on real tensors)."""
    _TLS.depth = getattr(_TLS, "depth", 0) + 1
    try:
        with unset_fake_temporarily():
            yield
    finally:
        _TLS.depth -= 1


@contextlib.contextmanager
def repeated(n: int):
    """Ops in this span count ``n`` times: the body of a loop whose ``n``
    iterations run the same ops on tensors of the same shapes, traced once
    (the sLSTM's time loop in a dry run: ``launch.dryrun.traced_loops``)."""
    old = getattr(_TLS, "repeats", 1)
    _TLS.repeats = old * n
    try:
        yield
    finally:
        _TLS.repeats = old


def in_planning() -> bool:
    """Whether this thread is inside DTensor's planning (see :func:`_planning`)."""
    return getattr(_TLS, "depth", 0) > 0


def _unfaked(fn):
    def run(*args, **kwargs):
        with _not_the_ranks_work():
            return fn(*args, **kwargs)

    return run


def _unfaked_memo(fn):
    """:func:`_unfaked` for a pure function of hashable arguments, each
    result kept: a strided shard's index arithmetic splits a ``torch.arange``
    of the dimension on every call (tens of ms at the production shapes,
    thousands of calls in a training step over 512 ranks)."""
    memo: dict = {}

    def run(*args, **kwargs):
        try:
            key = (args, tuple(sorted(kwargs.items())))
            hash(key)
        except TypeError:
            key = None
        if key is None or key not in memo:
            with _not_the_ranks_work():
                out = fn(*args, **kwargs)
            if key is None:
                return out
            memo[key] = out
        size, offsets = memo[key]
        return size, list(offsets) if isinstance(offsets, list) else offsets

    return run


# DTensor's planning that runs tensor ops: its shape inference (it runs
# the op on tensors of the global shapes) and a strided shard's index
# arithmetic (it splits a ``torch.arange``; under a ``FakeTensorMode`` that
# arange is fake and the ``.tolist()`` after it fails). Each is patched
# where this version of torch has it.
_PLANNERS = ((ShardingPropagator, "_propagate_tensor_meta_non_cached", _unfaked),
             (_StridedShard, "local_shard_size_and_offset", _unfaked_memo))


@contextlib.contextmanager
def _planning():
    """Mark DTensor's planning (``_PLANNERS``) while the counter runs."""
    saved = [(cls, name, cls.__dict__[name], wrap) for cls, name, wrap in _PLANNERS
             if name in cls.__dict__]
    for cls, name, fn, wrap in saved:
        setattr(cls, name, wrap(fn))
    try:
        yield
    finally:
        for cls, name, fn, _ in saved:
            setattr(cls, name, fn)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _trivial(func, args, kwargs) -> bool:
    packet = func._overloadpacket
    if func.is_view or packet in _TRIVIAL or packet is torch.ops._c10d_functional.wait_tensor:
        return True
    if packet is aten._to_copy:
        x = args[0]
        return ((kwargs.get("dtype") or x.dtype) == x.dtype
                and torch.device(kwargs.get("device") or x.device) == x.device)
    return False


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cost = OpCost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor dispatches; its local ops come back here
        out = func(*args, **kwargs)
        if not in_planning():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        one = OpCost()
        packet = func._overloadpacket
        ns, name = packet._qualified_op_name.split("::")
        formula = flop_registry.get(packet)
        one.flops = formula(*args, **kwargs, out_val=out) if formula is not None else 0
        if ns == "_c10d_functional" and name in COLLECTIVES:
            one.collective_bytes[COLLECTIVES[name]] = _nbytes(out)
        if ns == "repro_torch":
            one.kernel_calls[name] = 1
            one.kernel_flops[name] = one.flops
            one.hbm_bytes = _nbytes((args, kwargs)) + _nbytes(out)
        elif _trivial(func, args, kwargs):
            pass
        elif packet in _MATMULS:
            one.hbm_bytes = _nbytes(out) + sum(_nbytes(args[i]) for i in _MATMUL_OPERANDS[packet])
        else:
            # A gather reads only what it takes (2x its output), as any
            # other materialized result is written once and read once.
            one.hbm_bytes = 2 * _nbytes(out)
        n = getattr(_TLS, "repeats", 1)
        self.cost += one.scaled(n) if n != 1 else one


def _add(counts: dict, key: str, value: float) -> None:
    counts[key] = counts.get(key, 0.0) + value


def analyze_ops(fn, *args, **kwargs) -> tuple[OpCost, Any]:
    """``(cost, fn(*args, **kwargs))``: the ops this rank runs inside ``fn``,
    counted by the module's conventions. Enter a ``FakeTensorMode`` around
    it (outside this call) to count a step that does not fit a host."""
    counter = _Counter()
    with _planning(), counter:
        out = fn(*args, **kwargs)
    return counter.cost, out


def flop_counter_total(fn, *args, **kwargs) -> float:
    """``FlopCounterMode``'s total over ``fn(*args, **kwargs)``: on DTensors
    it sees each op once at the global shapes, so it counts the work of
    every rank (the counterpart of the reference's ``xla_cost_analysis``,
    kept to show why :func:`analyze_ops` exists)."""
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return float(fc.get_total_flops())
