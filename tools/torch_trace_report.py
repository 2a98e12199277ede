"""Offline trace analyzer on the PyTorch port: the debugging entry point
for serving traces. The twin of ``tools/trace_report.py``; it calls
``repro_torch`` only and runs on the host.

Loads a Chrome/Perfetto trace written by ``write_chrome_trace`` (of
``repro_torch.obs.export`` or of the JAX package: the format is one) and
prints:

  1. the per-epoch latency breakdown (collect / plan / commit wall time);
  2. the top-k slowest jobs with their queueing attribution — admission
     queueing vs the ``makespan - solver_makespan`` cross-job channel
     gap, split by wired/wireless resource;
  3. optionally, the full decision audit trail for one job id
     (``--job N``): every admission reorder, rejection proof, backfill
     verdict, and arbitration order that touched it.

``--json OUT.json`` additionally writes the same report (per-epoch
breakdown, commit-latency total, top-k slow jobs, optional audit) as a
machine-readable JSON document for dashboards and regression scripts.

Usage (from the repo root):

    PYTHONPATH=src python tools/torch_trace_report.py out.json [--top 10] \
        [--job 42] [--json report.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.obs.report import load_trace, render_report, report_dict  # noqa: E402


def main(argv: list[str] | None = None) -> dict:
    """Print the report and return it as the dict that ``--json`` writes."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="Perfetto trace JSON written by --trace")
    ap.add_argument(
        "--top", type=int, default=5, help="slowest jobs to show (default 5)"
    )
    ap.add_argument(
        "--job", type=int, default=None, help="print the decision audit for this job id"
    )
    ap.add_argument(
        "--json",
        default=None,
        metavar="OUT.json",
        help="also write the report as machine-readable JSON to this path",
    )
    args = ap.parse_args(argv)
    trace = load_trace(args.trace)
    print(render_report(trace, top=args.top, job=args.job))
    doc = report_dict(trace, top=args.top, job=args.job)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    return doc


if __name__ == "__main__":
    main()
