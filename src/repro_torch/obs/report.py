# Ported from src/repro/obs/report.py; imports retargeted to repro_torch.
"""Offline analysis of exported serving traces.

:mod:`tools.trace_report` is a thin CLI over this module: load a
Chrome/Perfetto trace written by
:func:`repro_torch.obs.export.write_chrome_trace` and answer the questions the
counters on :class:`~repro_torch.online.metrics.OnlineResult` cannot — where
did each epoch's wall time go (:func:`epoch_breakdown`), which jobs were
slowest and *why* (:func:`job_table`, with the ``makespan -
solver_makespan`` channel-queueing gap split by resource), and what
decisions touched one particular job (:func:`decision_audit`).

Everything operates on the parsed JSON dict, so tests and docs snippets
can feed :func:`repro_torch.obs.export.chrome_trace_events` output directly
without touching disk.
"""

from __future__ import annotations

import json

__all__ = [
    "commit_latency_total",
    "decision_audit",
    "epoch_breakdown",
    "job_table",
    "load_trace",
    "render_report",
    "report_dict",
]

# The three stage spans every epoch nests (see OnlineScheduler.serve).
STAGE_SPANS = ("collect_arrivals", "plan_batch", "arbitrate_and_commit")


def load_trace(path) -> dict:
    """Load a trace JSON file written by ``write_chrome_trace``."""
    with open(path) as f:
        return json.load(f)


def _span_events(trace: dict) -> "list[dict]":
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"]


def epoch_breakdown(trace: dict) -> "list[dict]":
    """Per-epoch wall-time table: one row per epoch, seconds per stage.

    Rows carry ``epoch``, ``total`` (the enclosing ``epoch`` span), one
    column per stage span, and the epoch-span attrs (``t``, ``n_pending``,
    ...) that were recorded at plan time.
    """
    rows: dict[int, dict] = {}
    for e in _span_events(trace):
        args = e.get("args", {})
        if "epoch" not in args:
            continue
        k = int(args["epoch"])
        row = rows.setdefault(
            k, {"epoch": k, "total": 0.0, **{s: 0.0 for s in STAGE_SPANS}}
        )
        dur_s = e.get("dur", 0.0) / 1e6
        if e["name"] == "epoch":
            row["total"] += dur_s
            for key, v in args.items():
                if key != "epoch":
                    row.setdefault(key, v)
        elif e["name"] in STAGE_SPANS:
            row[e["name"]] += dur_s
    return [rows[k] for k in sorted(rows)]


def commit_latency_total(trace: dict) -> float:
    """Summed wall seconds of the arbitrate-and-commit stage spans.

    Reconciles with ``sum(OnlineResult.epoch_commit_latency)`` (the
    ``track_epoch_latency`` timer wraps the same call the span wraps).
    """
    return sum(
        e.get("dur", 0.0) / 1e6
        for e in _span_events(trace)
        if e["name"] == "arbitrate_and_commit"
    )


def job_table(trace: dict, top: int = 5) -> "list[dict]":
    """Top-``top`` slowest jobs by JCT, with queueing attribution.

    Each row splits the job's arrival-to-completion time into admission
    queueing (``admit - arrival``), solver makespan, and the cross-job
    channel queueing gap ``makespan - solver_makespan`` — itself split
    into wired/wireless shares when the trace recorded the attribution.
    """
    jobs: dict[int, dict] = {}
    for e in trace["traceEvents"]:
        if e.get("cat") != "job":
            continue
        args = e.get("args", {})
        jid = int(args.get("job_id", e.get("id", -1)))
        row = jobs.setdefault(jid, {"job_id": jid})
        phase = args.get("phase")
        row[phase] = e["ts"] / 1e6
        for key in (
            "makespan",
            "solver_makespan",
            "queue_wired",
            "queue_wireless",
            "family",
            "backfilled",
            "tenant",
            "tier",
        ):
            if key in args:
                row[key] = args[key]
    out = []
    for row in jobs.values():
        if "arrival" not in row or "complete" not in row:
            continue
        row["jct"] = row["complete"] - row["arrival"]
        if "admit" in row:
            row["queueing_delay"] = row["admit"] - row["arrival"]
        if "makespan" in row and "solver_makespan" in row:
            row["channel_queueing"] = row["makespan"] - row["solver_makespan"]
        out.append(row)
    out.sort(key=lambda r: (-r["jct"], r["job_id"]))
    return out[: top if top else len(out)]


def decision_audit(trace: dict, job_id: int) -> "list[dict]":
    """Every decision event and lifecycle mark that touched ``job_id``.

    An event matches when its ``job_id`` arg equals the id or any of its
    list-valued args (e.g. an arbitration ``order``) contains it.
    Returned in timestamp order as ``{"t", "kind", "args"}`` rows (``t``
    in the event's own clock: wall seconds for decisions, simulated
    seconds for lifecycle marks).
    """
    rows = []
    for e in trace["traceEvents"]:
        cat, args = e.get("cat"), e.get("args", {})
        if cat == "job":
            if int(args.get("job_id", e.get("id", -1))) == job_id:
                rows.append(
                    {"t": e["ts"] / 1e6, "kind": f"job:{args.get('phase')}",
                     "args": args}
                )
        elif cat == "decision":
            hit = args.get("job_id") == job_id or any(
                isinstance(v, list) and job_id in v for v in args.values()
            )
            if hit:
                rows.append({"t": e["ts"] / 1e6, "kind": e["name"], "args": args})
    rows.sort(key=lambda r: r["t"])
    return rows


def report_dict(
    trace: dict, top: int = 5, job: "int | None" = None
) -> dict:
    """The report as one JSON-serializable dict (machine-readable twin of
    :func:`render_report` — same per-epoch breakdown and top-k slow jobs,
    plus the commit-latency total; ``decision_audit`` rows when ``job`` is
    given). Keys: ``epochs``, ``commit_latency_s``, ``slow_jobs``, and
    optionally ``audit`` = ``{"job_id", "events"}``.
    """
    out: dict = {
        "epochs": epoch_breakdown(trace),
        "commit_latency_s": commit_latency_total(trace),
        "slow_jobs": job_table(trace, top=top),
    }
    if job is not None:
        out["audit"] = {"job_id": job, "events": decision_audit(trace, job)}
    return out


def _fmt_ms(seconds: float) -> str:
    return f"{seconds * 1e3:9.3f}ms"


def render_report(trace: dict, top: int = 5, job: "int | None" = None) -> str:
    """Human-readable report: epoch breakdown, slow jobs, optional audit."""
    lines = []
    rows = epoch_breakdown(trace)
    lines.append(f"== per-epoch latency breakdown ({len(rows)} epochs) ==")
    lines.append(
        "epoch      total    collect       plan     commit"
    )
    for r in rows:
        lines.append(
            f"{r['epoch']:5d} {_fmt_ms(r['total'])} "
            f"{_fmt_ms(r['collect_arrivals'])} {_fmt_ms(r['plan_batch'])} "
            f"{_fmt_ms(r['arbitrate_and_commit'])}"
        )
    total = sum(r["total"] for r in rows)
    commit = commit_latency_total(trace)
    lines.append(f"total epoch wall {total:.4f}s  (commit stage {commit:.4f}s)")
    lines.append("")
    lines.append(f"== top {top} slowest jobs ==")
    for r in job_table(trace, top=top):
        parts = [f"job {r['job_id']:6d}  jct={r['jct']:9.2f}"]
        if "queueing_delay" in r:
            parts.append(f"queue={r['queueing_delay']:8.2f}")
        if "channel_queueing" in r:
            cq = f"channel={r['channel_queueing']:7.2f}"
            if "queue_wired" in r or "queue_wireless" in r:
                cq += (
                    f" (wired={r.get('queue_wired', 0.0):.2f}"
                    f" wireless={r.get('queue_wireless', 0.0):.2f})"
                )
            parts.append(cq)
        if r.get("backfilled"):
            parts.append("backfilled")
        if r.get("family"):
            parts.append(str(r["family"]))
        lines.append("  ".join(parts))
    if job is not None:
        lines.append("")
        lines.append(f"== decision audit for job {job} ==")
        audit = decision_audit(trace, job)
        if not audit:
            lines.append("(no events recorded for this job id)")
        for r in audit:
            args = {k: v for k, v in r["args"].items() if k != "phase"}
            lines.append(f"t={r['t']:12.4f}  {r['kind']:22s} {args}")
    return "\n".join(lines)
