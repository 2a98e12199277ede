# Ported from src/repro/obs/trace.py and extended: an installed tracer, the
# profiler mirror and device counters.
"""Structured tracing for the serving loop, the solver, and the model and
training paths.

The serving stack makes layered decisions per epoch — admission ordering,
coflow commit-order search, backfill proofs, portfolio budget splits —
and until now each layer only surfaced aggregate counters on
:class:`~repro_torch.online.metrics.OnlineResult`. This module records the
*structure*: nested wall-time spans (epoch → collect/plan/commit), typed
decision events at every admission/arbitration/backfill branch, per-job
lifecycle marks in simulated time, and a small metrics registry
(counters, gauges, :class:`~repro_torch.online.metrics.StreamingSeries`
histograms) that :mod:`repro_torch.obs.export` renders as a Chrome/Perfetto
trace and a Prometheus-style text exposition.

The scheduler takes its tracer as a ``tracer=`` argument. The model and
training paths (``runtime/steps.py``, ``optim/grad.py``, ``optim/adamw.py``,
``models/lm.py``, ``models/moe.py``) take none: they open their spans on
the process's current tracer, ``current().span(name)``, which is the one
:func:`installed` put in place, or :data:`NULL_TRACER`.

While a ``torch.profiler`` session records, every span of an enabled
tracer also opens ``torch.profiler.record_function`` under its own name,
so the program's phases land in the profile on the kernels' clock, each
with a device-side copy from its first kernel to its last. A counter
may be bumped by a 0-d device tensor: the running sum stays on the
device, and becomes a float only when it is read (:meth:`Tracer.counter`,
the exporters), so a traced step adds no host-device sync.

The default is :data:`NULL_TRACER`, whose every method is a no-op and
whose ``span`` returns a shared reusable context manager, so passing
``tracer=None``, or installing nothing, keeps the hot loop bit-identical
at negligible overhead (a global read and a call a span). Instrumented
call sites guard any *extra computation* (not just the record) behind
``tracer.enabled``.

One tracer serves one thread at a time. The autograd engine's thread
opens spans (the remat recompute) while the main thread waits in
``backward()``; those nest under the main thread's open span. Spans
opened from two threads at once would interleave on one stack.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import typing

import torch
from torch.autograd import profiler as _profiler

if typing.TYPE_CHECKING:  # pragma: no cover - type-only import
    from repro_torch.online.metrics import StreamingSeries

__all__ = [
    "Event",
    "JobMark",
    "NullTracer",
    "NULL_TRACER",
    "Span",
    "Tracer",
    "as_tracer",
    "current",
    "installed",
]


@dataclasses.dataclass
class Span:
    """One closed (or still-open) wall-time interval.

    ``t0``/``t1`` are seconds relative to the tracer's epoch
    (``Tracer.t0``); ``t1`` is NaN until the span exits. ``parent`` is
    the index of the enclosing span in ``Tracer.spans`` (-1 at top
    level), so the hierarchy is reconstructible offline.
    """

    name: str
    t0: float
    t1: float
    depth: int
    parent: int
    index: int
    attrs: dict

    @property
    def duration(self) -> float:
        """Wall seconds spent inside the span (NaN while open)."""
        return self.t1 - self.t0


@dataclasses.dataclass(frozen=True)
class Event:
    """One typed point-in-time decision record (wall-clock ``t``)."""

    kind: str
    t: float
    span: int
    attrs: dict


@dataclasses.dataclass(frozen=True)
class JobMark:
    """One job-lifecycle phase transition in *simulated* time.

    ``phase`` is one of ``"arrival"`` / ``"admit"`` / ``"complete"``;
    the exporter renders the marks of one ``job_id`` as an async track.
    """

    job_id: int
    phase: str
    t: float
    attrs: dict


class _SpanCtx:
    """Context manager handed out by :meth:`Tracer.span`.

    Reused objects are cheap but spans nest, so each ``span()`` call
    builds a fresh one; the :class:`NullTracer` instead hands out one
    shared no-op instance forever.
    """

    __slots__ = ("_tracer", "_span", "_mirror")

    def __init__(self, tracer: "Tracer", span: Span, mirror):
        self._tracer = tracer
        self._span = span
        self._mirror = mirror  # the span's record_function, under a profiler

    def __enter__(self) -> "_SpanCtx":
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tracer
        self._span.t1 = time.perf_counter() - tr.t0
        tr._stack.pop()
        if self._mirror is not None:
            self._mirror.__exit__(*exc)

    def set(self, **attrs) -> None:
        """Attach attributes discovered while the span is running."""
        self._span.attrs.update(attrs)

    @property
    def duration(self) -> float:
        """Wall seconds of the span (valid after exit; NaN while open)."""
        return self._span.duration


class _NullSpanCtx:
    """The shared no-op span context (singleton via :class:`NullTracer`)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpanCtx":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None

    @property
    def duration(self) -> float:
        return 0.0


class Tracer:
    """Collects spans, events, job marks, and scalar metrics in memory.

    All timestamps are ``time.perf_counter()`` seconds relative to the
    tracer's construction (``t0``), so exported traces start near zero.
    The metrics registry is deliberately tiny: ``counters`` are
    monotonically-growing floats, or 0-d device tensors where a device
    tensor was counted (read them with :meth:`counter`), ``gauges`` hold
    the last value set,
    and ``series`` maps ``(name, labels)`` to a
    :class:`~repro_torch.online.metrics.StreamingSeries` — the same O(1)
    sketch the serving layer already uses — so histogram state stays
    bounded on 100k-job serves.
    """

    enabled: bool = True

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.spans: list[Span] = []
        self.events: list[Event] = []
        self.job_marks: list[JobMark] = []
        self.counters: dict[str, float] = {}
        self.gauges: dict[tuple[str, tuple], float] = {}
        self.series: dict[tuple[str, tuple], StreamingSeries] = {}
        self._stack: list[int] = []

    # -- spans / events / job marks ------------------------------------

    def span(self, name: str, **attrs) -> _SpanCtx:
        """Open a nested wall-time span; use as a context manager. Under a
        recording ``torch.profiler`` it is also a ``record_function`` of
        the same name."""
        sp = Span(
            name=name,
            t0=time.perf_counter() - self.t0,
            t1=float("nan"),
            depth=len(self._stack),
            parent=self._stack[-1] if self._stack else -1,
            index=len(self.spans),
            attrs=attrs,
        )
        self.spans.append(sp)
        self._stack.append(sp.index)
        mirror = None
        if _profiler._is_profiler_enabled:
            mirror = _profiler.record_function(name)
            mirror.__enter__()
        return _SpanCtx(self, sp, mirror)

    def event(self, kind: str, **attrs) -> None:
        """Record a typed decision event at the current wall time."""
        self.events.append(
            Event(
                kind=kind,
                t=time.perf_counter() - self.t0,
                span=self._stack[-1] if self._stack else -1,
                attrs=attrs,
            )
        )

    def job(self, job_id: int, phase: str, sim_time: float, **attrs) -> None:
        """Record a job lifecycle mark at simulated time ``sim_time``."""
        self.job_marks.append(
            JobMark(job_id=int(job_id), phase=phase, t=float(sim_time), attrs=attrs)
        )

    # -- metrics registry ----------------------------------------------

    @staticmethod
    def _key(name: str, labels: dict) -> tuple[str, tuple]:
        return name, tuple(sorted(labels.items()))

    def count(self, name: str, inc: "float | torch.Tensor" = 1.0) -> None:
        """Increment a monotone counter. A 0-d tensor ``inc`` keeps the
        running sum a tensor on its device, in its dtype: no sync."""
        prev = self.counters.get(name)
        if prev is not None:
            self.counters[name] = prev + inc
        elif isinstance(inc, torch.Tensor):
            self.counters[name] = inc.detach().clone()
        else:
            self.counters[name] = 0.0 + inc

    def counter(self, name: str) -> float:
        """A counter's value as a float (0 if never counted); a device
        counter is read from the device here."""
        return float(self.counters.get(name, 0.0))

    def gauge(self, name: str, value: float, **labels) -> None:
        """Set a gauge to its latest value (labelled)."""
        self.gauges[self._key(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        """Push one observation into a labelled histogram series."""
        # Local import: repro_torch.online.service/cluster import this module,
        # so a top-level metrics import would cycle through the package
        # __init__ when repro_torch.obs loads first.
        from repro_torch.online.metrics import StreamingSeries

        key = self._key(name, labels)
        s = self.series.get(key)
        if s is None:
            s = self.series[key] = StreamingSeries()
        s.push(value)

    def adopt_series(self, name: str, series: "StreamingSeries", **labels) -> None:
        """Register an existing series (e.g. a per-tenant sketch) by ref."""
        self.series[self._key(name, labels)] = series

    # -- convenience ---------------------------------------------------

    def spans_named(self, name: str) -> "list[Span]":
        return [s for s in self.spans if s.name == name]


class NullTracer:
    """No-op tracer: every method returns immediately.

    ``enabled`` is False so call sites can skip computing span/event
    *arguments* entirely; ``span()`` returns one shared context manager
    whose enter/exit do nothing, keeping per-epoch overhead to a couple
    of attribute lookups.
    """

    enabled: bool = False
    _CTX = _NullSpanCtx()

    def span(self, name: str, **attrs) -> _NullSpanCtx:
        return self._CTX

    def event(self, kind: str, **attrs) -> None:
        return None

    def job(self, job_id: int, phase: str, sim_time: float, **attrs) -> None:
        return None

    def count(self, name: str, inc: "float | torch.Tensor" = 1.0) -> None:
        return None

    def gauge(self, name: str, value: float, **labels) -> None:
        return None

    def observe(self, name: str, value: float, **labels) -> None:
        return None

    def adopt_series(self, name: str, series: "StreamingSeries", **labels) -> None:
        return None


NULL_TRACER = NullTracer()


def as_tracer(tracer: "Tracer | NullTracer | None") -> "Tracer | NullTracer":
    """Normalize an optional tracer argument (``None`` → the null tracer)."""
    return NULL_TRACER if tracer is None else tracer


_current: "Tracer | NullTracer | None" = None  # set by installed()


def current() -> "Tracer | NullTracer":
    """The process's installed tracer, or :data:`NULL_TRACER`."""
    tr = _current
    return NULL_TRACER if tr is None else tr


@contextlib.contextmanager
def installed(tracer: "Tracer | NullTracer"):
    """Make ``tracer`` the process's current tracer for the block, and put
    the previous one back on exit, also on an exception."""
    global _current
    prev = _current
    _current = tracer
    try:
        yield tracer
    finally:
        _current = prev
