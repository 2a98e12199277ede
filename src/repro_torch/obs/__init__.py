# Ported from src/repro/obs/__init__.py and extended: installed() and current().
"""Structured tracing and metrics export for the serving loop, the solver,
and the model and training paths.

Public surface:

* :class:`~repro_torch.obs.trace.Tracer` / :class:`~repro_torch.obs.trace.NullTracer`
  — nested wall-time spans, typed decision events, per-job lifecycle
  marks, counters/gauges/histograms. Under a recording
  ``torch.profiler`` each span is also a ``record_function`` of its name;
  a counter may sum 0-d device tensors on the device.
* :func:`~repro_torch.obs.trace.installed` /
  :func:`~repro_torch.obs.trace.current` — the process's tracer, which
  the model and training paths (``runtime/steps.py``, ``optim``,
  ``models/lm.py``, ``models/moe.py``) open their spans on.
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
    current,
    installed,
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
    "current",
    "installed",
    "prometheus_exposition",
    "write_chrome_trace",
]
