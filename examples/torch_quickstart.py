"""Quickstart on the PyTorch port: solve one hybrid-DCN joint scheduling
instance end to end.

Builds a production-style DAG job, solves it optimally with and without
wireless bandwidth augmentation (the paper's core experiment), executes both
schedules in the discrete-event simulator, and prints the verified timeline.
Every step runs on the host, as in ``examples/quickstart.py``; this twin
calls ``repro_torch`` only.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (
    ProblemInstance,
    check_feasible,
    g_list_schedule,
    lower_bound,
    make_onestage_mapreduce,
    solve_bnb,
    upper_bound,
    wired_only,
)


def main(argv: list[str] | None = None) -> dict:
    """Print the quickstart and return its numbers."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    rng = np.random.default_rng(7)
    job = make_onestage_mapreduce(rng, n_map=4, n_reduce=2, rho=1.0)
    inst = ProblemInstance(job=job, n_racks=4, n_wireless=2)
    out = dict(t_min=lower_bound(inst), t_max=upper_bound(inst))

    print(f"job: {job.n_tasks} tasks, {job.n_edges} edges (one-stage MapReduce)")
    print(f"bounds: T_min={out['t_min']:.1f}  T_max={out['t_max']:.1f}")

    out["heuristic"] = g_list_schedule(inst, use_wireless=True).makespan
    print(f"G-List heuristic:            {out['heuristic']:8.2f}")

    opt0 = solve_bnb(wired_only(inst), time_limit=30)
    print(f"optimal, wired only:         {opt0.makespan:8.2f} "
          f"(proved={opt0.proved_optimal})")

    opt2 = solve_bnb(inst, time_limit=30)
    print(f"optimal, +2 wireless:        {opt2.makespan:8.2f} "
          f"(proved={opt2.proved_optimal})")
    gain = 100 * (1 - opt2.makespan / opt0.makespan)
    print(f"wireless augmentation gain:  {gain:8.1f}%")
    out.update(wired=opt0.makespan, wireless=opt2.makespan, gain=gain,
               wired_proved=opt0.proved_optimal, wireless_proved=opt2.proved_optimal)

    # Independently verify both schedules against OP's constraints.
    check_feasible(inst, opt2.schedule)
    check_feasible(wired_only(inst), opt0.schedule)
    print("\ntimeline (optimal with wireless):")
    s = opt2.schedule
    for v in np.argsort(s.start):
        print(f"  task {v}: rack {s.rack[v]}  t=[{s.start[v]:7.2f}, "
              f"{s.start[v] + job.p[v]:7.2f})")
    names = {0: "wired", 1: "local"}
    for e in range(job.n_edges):
        u, v = job.edges[e]
        ch = names.get(int(s.chan[e]), f"wireless{int(s.chan[e]) - 2}")
        print(f"  edge {u}->{v}: {ch:10s} start={s.tstart[e]:7.2f}")
    out["start"] = [float(t) for t in s.start]
    return out


if __name__ == "__main__":
    main()
