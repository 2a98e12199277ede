# Copied from src/repro/obs/trace.py; imports retargeted to repro_torch.
"""Zero-dependency structured tracing for the serving loop and solver.

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

Everything is plain Python on the host — no jax, no I/O — so a traced
serve differs from an untraced one only by appending records to lists.
The default is :data:`NULL_TRACER`, whose every method is a no-op and
whose ``span`` returns a shared reusable context manager, so passing
``tracer=None`` anywhere keeps the hot loop bit-identical at negligible
overhead (the stress lane asserts < 2%). Instrumented call sites guard
any *extra computation* (not just the record) behind ``tracer.enabled``.
"""

from __future__ import annotations

import dataclasses
import time
import typing

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

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> "_SpanCtx":
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tracer
        self._span.t1 = time.perf_counter() - tr.t0
        tr._stack.pop()

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
    The metrics registry is deliberately tiny: ``counters`` are plain
    monotonically-growing floats, ``gauges`` hold the last value set,
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
        """Open a nested wall-time span; use as a context manager."""
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
        return _SpanCtx(self, sp)

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

    def count(self, name: str, inc: float = 1.0) -> None:
        """Increment a monotone counter."""
        self.counters[name] = self.counters.get(name, 0.0) + inc

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

    def events_of(self, kind: str) -> "list[Event]":
        return [e for e in self.events if e.kind == kind]


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

    def count(self, name: str, inc: float = 1.0) -> None:
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
