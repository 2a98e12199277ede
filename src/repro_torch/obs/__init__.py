# Ported from src/repro/obs/__init__.py; imports retargeted to repro_torch.
"""Structured tracing and metrics export for the serving loop and solver.

Public surface:

* :class:`~repro_torch.obs.trace.Tracer` / :class:`~repro_torch.obs.trace.NullTracer`
  — nested wall-time spans, typed decision events, per-job lifecycle
  marks, counters/gauges/histograms.
* :func:`~repro_torch.obs.export.write_chrome_trace` /
  :func:`~repro_torch.obs.export.chrome_trace_events` — Chrome/Perfetto
  ``trace_event`` JSON.
* :func:`~repro_torch.obs.export.prometheus_exposition` — Prometheus text
  format of the metrics registry.
* :mod:`repro_torch.obs.report` — offline per-epoch / per-job analysis
  (the repo's ``tools/trace_report.py`` reads the same trace format).
"""

from repro_torch.obs.export import (
    chrome_trace_events,
    prometheus_exposition,
    write_chrome_trace,
)
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
    "chrome_trace_events",
    "prometheus_exposition",
    "write_chrome_trace",
]
