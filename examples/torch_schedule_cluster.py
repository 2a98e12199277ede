"""Periodic multi-job cluster scheduling (the paper's production scenario)
on the PyTorch port: a day's worth of periodic jobs ([15]-style workload)
on a hybrid DCN. The heterogeneous fleet is solved in ONE padded
mega-batch (`schedule_fleet`: shared launches + combined §IV-A LB pruning
across all jobs at once, the bound in the `cpm_fleet_lb` CUDA kernel),
with the full refinement portfolio polishing the sampled-regime jobs,
cross-checked per job against exact B&B under wired-only vs
wireless-augmented operation, plus a straggler re-plan. The twin of
``examples/schedule_cluster.py``, with its defaults; it calls
``repro_torch`` only.

Run:  PYTHONPATH=src python examples/torch_schedule_cluster.py            # on the card
      PYTHONPATH=src python examples/torch_schedule_cluster.py --device cpu

``--jobs``, ``--samples`` and ``--time-limit`` shrink the scenario (the
original's 8 jobs, 2,048 samples and 10 s a B&B solve by default). The
straggler re-plan prices the backward pass at the H100's dense bf16 rate
(``backward_profile``'s default in the port), so its step times differ
from the original's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import ProblemInstance, random_job, schedule_fleet, solve_bnb, wired_only
from repro_torch.device import resolve_device
from repro_torch.distribution.plan import LinkSpec, backward_profile, replan


def main(argv: list[str] | None = None) -> dict:
    """Print the scenario and return its numbers: per job, the B&B optima
    (``wired``, ``augmented``) with their proofs and walls, the fleet's
    makespan and pruning; the fleet's totals; the re-plan's step times.
    ``fleet_result`` and ``instances`` are the engine's own objects."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--time-limit", type=float, default=10.0, help="seconds a B&B solve")
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n_jobs = args.jobs
    total0, total2, proved = 0.0, 0.0, 0
    print(f"scheduling {n_jobs} periodic jobs (tasks ~ U[5,10], rho=0.5) ...")
    insts = []
    for j in range(n_jobs):
        job = random_job(np.random.default_rng(100 + j), None, rho=0.5)
        insts.append(ProblemInstance(job=job, n_racks=8, n_wireless=2))

    # The whole heterogeneous fleet in one mega-batch search; sampled-regime
    # jobs get the full strategy portfolio for refinement.
    t = time.perf_counter()
    fleet = schedule_fleet(
        insts, max_enumerate=20_000, n_samples=args.samples, strategies="portfolio",
        device=dev,
    )
    fleet_wall = time.perf_counter() - t

    jobs = []
    for j, (inst, rv) in enumerate(zip(insts, fleet.results)):
        r0 = solve_bnb(wired_only(inst), time_limit=args.time_limit)
        r2 = solve_bnb(inst, time_limit=args.time_limit)
        total0 += r0.makespan
        total2 += r2.makespan
        proved += r2.proved_optimal
        print(
            f"  job {j}: |V|={inst.job.n_tasks:2d} wired={r0.makespan:7.1f} "
            f"+wireless={r2.makespan:7.1f} "
            f"gain={100 * (1 - r2.makespan / r0.makespan):5.1f}% "
            f"fleet-search={rv.makespan:7.1f} "
            f"(pruned {rv.n_pruned}/{rv.n_candidates})"
        )
        jobs.append(dict(
            n_tasks=inst.job.n_tasks, wired=r0.makespan, augmented=r2.makespan,
            wired_proved=r0.proved_optimal, augmented_proved=r2.proved_optimal,
            wired_wall_s=r0.wall_s, augmented_wall_s=r2.wall_s,
            wired_schedule=r0.schedule, augmented_schedule=r2.schedule,
            fleet=float(rv.makespan), pruned=rv.n_pruned, candidates=rv.n_candidates))
    print(
        f"\nfleet: avg wired JCT={total0 / n_jobs:.1f}, augmented="
        f"{total2 / n_jobs:.1f} ({100 * (1 - total2 / total0):.1f}% reduction, "
        f"{proved}/{n_jobs} proved optimal); mega-batch engine avg JCT="
        f"{float(fleet.makespans.mean()):.1f} with "
        f"{fleet.n_pruned}/{fleet.n_candidates} candidates LB-pruned in "
        f"{fleet.n_stage1_launches}+{fleet.n_stage2_launches} shared launches "
        f"({fleet.n_stage1_traces}+{fleet.n_stage2_traces} program traces)"
    )
    if fleet.strategy_stats:
        counters = "; ".join(
            f"{name}: {s.evaluated} evaluated, {s.improved} improving, "
            f"yield={s.yield_per_eval:.3f}, w={s.weight:.2f}"
            for name, s in sorted(fleet.strategy_stats.items())
        )
        print(f"refinement portfolio: {counters}")

    # Straggler mitigation on the training-integration side.
    cfg = get_config("llama3_2_3b")
    g_secs, g_bytes = backward_profile(cfg, tokens_per_device=4096)
    healthy = replan(g_secs, g_bytes, LinkSpec())
    degraded = replan(g_secs, g_bytes, LinkSpec(), compute_slowdown=1.6, degraded_aux=1)
    print(
        f"\nstraggler re-plan: healthy step {healthy.t_optimal:.3f}s -> "
        f"degraded pod (1.6x compute, 1 aux circuit lost) {degraded.t_optimal:.3f}s; "
        f"schedule re-derived in-flight (fault-tolerance hook)"
    )
    return dict(
        jobs=jobs, instances=insts, fleet_result=fleet, fleet_wall_s=fleet_wall,
        mean_wired=total0 / n_jobs, mean_augmented=total2 / n_jobs, proved=proved,
        fleet_mean=float(fleet.makespans.mean()), n_pruned=fleet.n_pruned,
        n_candidates=fleet.n_candidates, stage1_launches=fleet.n_stage1_launches,
        stage2_launches=fleet.n_stage2_launches, healthy_step_s=healthy.t_optimal,
        degraded_step_s=degraded.t_optimal)


if __name__ == "__main__":
    main()
