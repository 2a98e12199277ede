# Ported from src/repro/obs/export.py; imports retargeted to repro_torch, and
# counters read through Tracer.counter (a device counter is read there).
"""Exporters for :class:`~repro_torch.obs.trace.Tracer` state.

Two render targets, both text, both dependency-free:

* :func:`chrome_trace_events` / :func:`write_chrome_trace` — the Chrome
  / Perfetto ``trace_event`` JSON format (load at ``ui.perfetto.dev`` or
  ``chrome://tracing``). Wall-clock spans become "X" complete events on
  pid 1 (one thread row per nesting depth); decision events become "i"
  instants; job lifecycle marks become async "b"/"n"/"e" tracks on pid 2
  with *simulated* time as the timestamp axis, so a job's
  arrival→admit→complete bar is its queueing delay + execution laid out
  on the serve's own clock.
* :func:`prometheus_exposition` — Prometheus text format of the metrics
  registry: counters, labelled gauges, and summary-style quantile lines
  rendered from each :class:`~repro_torch.online.metrics.StreamingSeries`.
  Zero-sample series emit their ``_count``/``_sum`` lines but *omit*
  quantile lines (a quantile of nothing is not 0).
"""

from __future__ import annotations

import json
import math
import typing

if typing.TYPE_CHECKING:  # pragma: no cover - type-only import
    from repro_torch.obs.trace import Tracer

__all__ = [
    "chrome_trace_events",
    "prometheus_exposition",
    "write_chrome_trace",
]

# Perfetto pids: wall-clock spans/events vs simulated-time job tracks.
PID_WALL = 1
PID_SIM = 2

_US = 1e6  # trace_event timestamps are microseconds


def _json_safe(v):
    """Coerce attr values into JSON-serializable plain types."""
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    try:  # numpy scalars expose .item()
        return _json_safe(v.item())
    except AttributeError:
        return repr(v)


def _args(attrs: dict) -> dict:
    return {str(k): _json_safe(v) for k, v in attrs.items()}


def chrome_trace_events(tracer: "Tracer") -> dict:
    """Render the tracer as a Chrome ``trace_event`` JSON object."""
    ev: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": PID_WALL,
            "args": {"name": "serving wall clock"},
        },
        {
            "name": "process_name",
            "ph": "M",
            "pid": PID_SIM,
            "args": {"name": "jobs (simulated time)"},
        },
    ]
    for sp in tracer.spans:
        t1 = sp.t1 if math.isfinite(sp.t1) else sp.t0
        ev.append(
            {
                "name": sp.name,
                "cat": "span",
                "ph": "X",
                "pid": PID_WALL,
                # One thread row per nesting depth keeps child spans
                # visually inside their parents without tid bookkeeping.
                "tid": sp.depth,
                "ts": sp.t0 * _US,
                "dur": max(t1 - sp.t0, 0.0) * _US,
                "args": _args(sp.attrs),
            }
        )
    for e in tracer.events:
        ev.append(
            {
                "name": e.kind,
                "cat": "decision",
                "ph": "i",
                "s": "t",
                "pid": PID_WALL,
                "tid": 0,
                "ts": e.t * _US,
                "args": _args(e.attrs),
            }
        )
    _PH = {"arrival": "b", "admit": "n", "complete": "e"}
    for m in tracer.job_marks:
        ph = _PH.get(m.phase, "n")
        ev.append(
            {
                "name": "job" if ph != "n" else m.phase,
                "cat": "job",
                "ph": ph,
                "id": m.job_id,
                "pid": PID_SIM,
                "tid": 0,
                "ts": m.t * _US,
                "args": _args(dict(m.attrs, job_id=m.job_id, phase=m.phase)),
            }
        )
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer: "Tracer", path) -> None:
    """Serialize :func:`chrome_trace_events` to ``path`` as JSON."""
    with open(path, "w") as f:
        json.dump(chrome_trace_events(tracer), f)


def _labels(label_items: tuple) -> str:
    if not label_items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in label_items)
    return "{" + body + "}"


def prometheus_exposition(tracer: "Tracer") -> str:
    """Render counters/gauges/series as Prometheus text exposition."""
    lines: list[str] = []
    for name in sorted(tracer.counters):
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {tracer.counter(name):g}")
    seen_gauges: set[str] = set()
    for (name, labels), v in sorted(tracer.gauges.items()):
        if name not in seen_gauges:
            seen_gauges.add(name)
            lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{_labels(labels)} {v:g}")
    seen_series: set[str] = set()
    for (name, labels), s in sorted(tracer.series.items()):
        if name not in seen_series:
            seen_series.add(name)
            lines.append(f"# TYPE {name} summary")
        if s.count:
            for p in s.quantiles:
                items = labels + (("quantile", f"{p:g}"),)
                lines.append(f"{name}{_labels(items)} {s.quantile(p):g}")
        lines.append(f"{name}_count{_labels(labels)} {s.count}")
        # mean is NaN on an empty series; the sum of nothing is 0.
        total = s.mean * s.count if s.count else 0.0
        lines.append(f"{name}_sum{_labels(labels)} {total:g}")
    return "\n".join(lines) + "\n"
