"""Online arrival-driven serving (the paper's §V production scenario) on
the PyTorch port: jobs arrive over time, queue for residual cluster
capacity, and are (re-)optimized in windowed `schedule_fleet` mega-batches
(the §IV-A bound in the `cpm_fleet_lb` CUDA kernel). Queued jobs are
re-planned every epoch with warm-started search (incumbent seed pools +
keep-incumbent commits), and the same trace is replayed under the online
FIFO-solo and greedy-list baselines for comparison. A final O(active)
pass re-serves the trace from a lazy arrival stream with interval-index
compaction and streaming-only stats — bit-identical JCTs, O(1) memory.
The twin of ``examples/serve_jobs.py``, with its defaults; it calls
``repro_torch`` only.

Run:  PYTHONPATH=src python examples/torch_serve_jobs.py            # on the card
      PYTHONPATH=src python examples/torch_serve_jobs.py --device cpu

``--jobs`` shortens the trace (10 jobs by default, as the original's).
"""

from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.online import (
    OnlineScheduler,
    production_arrivals,
    stream_production_arrivals,
)

CLUSTER = dict(n_racks=6, n_wireless=2)
SOLVER = dict(
    max_enumerate=64, n_samples=64, batch_size=256,
    refine_rounds=2, refine_pool=96, strategies="portfolio",
)


def main(argv: list[str] | None = None) -> dict:
    """Print the serves and return their numbers: each policy's JCTs in
    job order (``jct``), mean JCT and the printed summary figures."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=10)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arrivals = production_arrivals(
        seed=0, rate=1 / 40, n_jobs=args.jobs, min_rack_demand=4, **CLUSTER
    )
    print(
        f"production-mix trace: {len(arrivals)} jobs over "
        f"{arrivals[-1].time:.0f} time units on a "
        f"{CLUSTER['n_racks']}-rack / {CLUSTER['n_wireless']}-subchannel cluster"
    )

    service = dict(
        window=5.0, require_full_demand=True, preserve_order=True,
        solver_kwargs=SOLVER, seed=0, device=dev,
    )
    svc = OnlineScheduler(
        CLUSTER["n_racks"], CLUSTER["n_wireless"], warm_start=True, **service
    )
    res = svc.serve(arrivals)

    print("\n  id family              arrive  admit  racks  makespan  queue     JCT")
    for j in res.jobs:
        print(
            f"  {j.job_id:2d} {j.family:<19s} {j.arrival:6.0f} {j.admitted:6.0f} "
            f"{j.n_racks_granted:5d} {j.makespan:9.1f} {j.queueing_delay:6.1f} "
            f"{j.jct:7.1f}  ({j.n_solves} solve{'s' if j.n_solves > 1 else ''})"
        )
    print(f"\nfleet (warm): {res.summary()}")
    print(
        f"    queue p50/p90/p99 = {res.p50_queueing_delay:.1f}/"
        f"{res.p90_queueing_delay:.1f}/{res.p99_queueing_delay:.1f}, "
        f"jct p50/p90/p99 = {res.p50_jct:.1f}/{res.p90_jct:.1f}/"
        f"{res.p99_jct:.1f}, peak active {res.peak_active}, "
        f"peak queue {res.peak_queue_depth}"
    )
    res.timeline.assert_feasible(full=True)  # committed timeline is channel-feasible
    out = {"fleet": dict(jct=[j.jct for j in res.jobs], mean_jct=res.mean_jct,
                         p50_jct=res.p50_jct, p90_jct=res.p90_jct, p99_jct=res.p99_jct,
                         makespan=[j.makespan for j in res.jobs],
                         admitted=[j.admitted for j in res.jobs])}

    # Channel-proven backfilling: overtake the blocked head-of-line job
    # only when arbitration proves its admission epoch cannot slip.
    bf = OnlineScheduler(
        CLUSTER["n_racks"], CLUSTER["n_wireless"], warm_start=True,
        backfill=True, **service,
    ).serve(arrivals)
    print(
        f"    backfill: mean JCT {bf.mean_jct:7.1f} "
        f"({100 * (bf.mean_jct / res.mean_jct - 1):+.1f}% vs FIFO), "
        f"{bf.n_backfilled} backfilled, "
        f"{bf.n_backfill_rejected} candidates rejected by the no-delay proof"
    )
    out["backfill"] = dict(jct=[j.jct for j in bf.jobs], mean_jct=bf.mean_jct,
                           n_backfilled=bf.n_backfilled)

    for policy in ("greedy_list", "fifo_solo"):
        base = OnlineScheduler(
            CLUSTER["n_racks"], CLUSTER["n_wireless"], policy=policy, **service
        ).serve(arrivals)
        print(
            f"{policy:>12s}: mean JCT {base.mean_jct:7.1f} "
            f"(+{100 * (base.mean_jct / res.mean_jct - 1):.1f}% vs fleet), "
            f"p95 {base.p95_jct:.1f}, queue {base.mean_queueing_delay:.1f}"
        )
        out[policy] = dict(jct=[j.jct for j in base.jobs], mean_jct=base.mean_jct,
                           p95_jct=base.p95_jct)

    # O(active) serving: same trace as a lazy stream, compaction on,
    # per-job records elided — the committed schedule is bit-identical.
    stream = stream_production_arrivals(
        seed=0, rate=1 / 40, n_jobs=args.jobs, min_rack_demand=4, **CLUSTER
    )
    lean = OnlineScheduler(
        CLUSTER["n_racks"], CLUSTER["n_wireless"], warm_start=True,
        compact_interval=4, record_jobs=False, **service,
    ).serve(stream)
    assert abs(lean.mean_jct - res.mean_jct) < 1e-9
    print(
        f"   streaming: mean JCT {lean.mean_jct:7.1f} (bit-identical), "
        f"{lean.timeline.n_compacted} intervals compacted, "
        f"{lean.timeline.n_intervals} retained"
    )
    out["streaming"] = dict(mean_jct=lean.mean_jct, n_compacted=lean.timeline.n_compacted,
                            n_retained=lean.timeline.n_intervals)
    return out


if __name__ == "__main__":
    main()
