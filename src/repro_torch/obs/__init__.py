# Ported from src/repro/obs/__init__.py: exports only what is ported so far.
"""Structured tracing for the serving loop and solver.

Public surface:

* :class:`~repro_torch.obs.trace.Tracer` / :class:`~repro_torch.obs.trace.NullTracer`
  — nested wall-time spans, typed decision events, per-job lifecycle
  marks, counters/gauges/histograms.

The Chrome/Perfetto and Prometheus exporters (``obs/export.py``) and the
offline report (``obs/report.py``) are not ported yet.
"""

from repro_torch.obs.trace import (
    NULL_TRACER,
    Event,
    JobMark,
    NullTracer,
    Span,
    Tracer,
    as_tracer,
)

__all__ = [
    "Event",
    "JobMark",
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "Tracer",
    "as_tracer",
]
