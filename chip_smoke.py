#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/``, then:

  0. prints the card's name and power limit, the torch and CUDA versions
     and the build time;
  1. holds every kernel entry point against its plain PyTorch version on
     the card (tolerance 0: ``torch.equal``) at the offline main-path
     shape, the serving shape and ragged shapes, and times both with CUDA
     events;
  2. solves the stress lane's 16-job production fleet offline with
     ``schedule_fleet`` at the engine defaults, with and without a
     restricted topology, and checks fleet == solo, feasibility, and
     card == CPU on a 4-instance subset;
  3. serves the ``production_fleet`` golden stream (exact fingerprint),
     a 200-job production stream with the default fleet policy, and the
     same stream under ``topology="matching"``;
  4. profiles the offline fleet and a 20-job serve with torch.profiler
     (device time by kernel, busy share, kernel count);

and prints the kernel table and, as its last line,
``{"ok": true, "device": {...}}``. Every check raises on failure. It
exits non-zero, printing no result, when no card is available or when
``src/repro_torch`` is missing. The launch counters are reset just before
phase 2 and read just after phase 3: that is the main-path run whose
launches the kernel table reports.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM rate and float32
# outside the tensor cores; the bound of a kernel is the larger of
# bytes / HBM rate and operations / float32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# tests/test_admission.py GOLDEN["production_fleet"].
GOLDEN_FLEET_ROWS = [
    (0, 6.1001481267803985, 217.14539798702484, 211.04524986024444, 5, 2),
    (1, 18.262137412159362, 271.7465923371507, 253.48445492499133, 2, 0),
    (2, 217.14539798702484, 348.5513576149018, 131.40595962787697, 4, 2),
    (3, 217.14539798702484, 691.8271308510732, 474.6817328640484, 1, 0),
    (4, 271.7465923371507, 395.1547551642818, 123.40816282713115, 3, 1),
]
GOLDEN_FLEET_COUNTERS = dict(
    n_epochs=6, n_served=5, n_backfilled=0, horizon=691.8271308510732
)

SERVE_JOBS = 200
PROFILE_JOBS = 20
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/cpm.cu"
REPLACES = {
    "combined_lb": "src/repro/kernels/cpm.py:93",
    "combined_lb_masked": "src/repro/kernels/cpm.py:101",
    "critical_path": "src/repro/kernels/cpm.py:56",
}


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device ms per call over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def lb_inputs(np, torch, rng, B: int, n: int):
    """Ragged DAG mega-batch on the card: rows of 0..n live nodes, -inf
    no-edges, ``extra`` -inf, dominated or dominating, and a mask that is
    zero on some edges and a positive uplift on others."""
    nb = rng.integers(0, n + 1, size=B)
    live = np.arange(n)[None, :] < nb[:, None]
    upper = np.triu(np.ones((n, n), bool), 1)
    edge = (rng.random((B, n, n), dtype=np.float32) < 0.3) & upper & live[:, None, :]
    w = np.where(edge, rng.uniform(1, 10, (B, n, n)).astype(np.float32), -np.inf)
    p = np.where(live, rng.uniform(1, 100, (B, n)), 0).astype(np.float32)
    kind = rng.integers(0, 3, size=B)
    extra = np.where(
        kind == 0, -np.inf, np.where(kind == 1, rng.uniform(0, 50, B), 1e4)
    ).astype(np.float32)
    mask = np.where(
        edge & (rng.random((B, n, n), dtype=np.float32) < 0.5),
        rng.uniform(0, 20, (B, n, n)).astype(np.float32), 0,
    ).astype(np.float32)
    dev = torch.device("cuda")
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
        for a in (w, p, extra, mask)
    )


def bound(B: int, n: int, n_iters: int, kind: str) -> tuple[float, str]:
    """Least ms the card could take: each input read once, each output
    written once, over HBM rate; max/add operations over the f32 rate."""
    tile = B * n * n * 4
    if kind == "critical_path":
        nbytes = tile + B * n * 4
        ops = B * 2 * n_iters * n * n
    else:
        nbytes = tile + B * n * 4 + B * 4 + B * 4
        ops = B * (2 * n_iters * n * n + 2 * n + 1)
        if kind == "combined_lb_masked":
            nbytes += tile
            ops += B * n * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_run(label: str, fn, wall_unprofiled: float) -> None:
    """Run ``fn`` under torch.profiler and emit device time per kernel
    name (top 8), the total, the number of device kernels, and the busy
    share of ``wall_unprofiled`` (the same work's wall time without the
    profiler). Prints "not measured" fields when the profiler records no
    device time on this machine."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t

    def dev_us(e):
        if hasattr(e, "self_device_time_total"):
            return e.self_device_time_total
        return e.self_cuda_time_total

    # Device-side rows only (kernels, copies): a host op's row repeats the
    # time of the kernels it launched.
    rows = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and dev_us(e) > 0
    ]
    total_us = sum(dev_us(e) for e in rows)
    if not rows:
        emit("profile", run=label, device_time="not measured", wall_s=wall)
        return
    top = sorted(rows, key=dev_us, reverse=True)[:8]
    emit("profile", run=label, wall_profiled_s=wall,
         wall_unprofiled_s=wall_unprofiled, device_s=total_us / 1e6,
         busy_share_of_unprofiled=total_us / 1e6 / wall_unprofiled,
         device_kernels=sum(e.count for e in rows),
         top=[dict(name=e.key[:80], device_ms=dev_us(e) / 1e3, count=e.count)
              for e in top])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import check_feasible
    from repro_torch.core.instance import Topology
    from repro_torch.core.vectorized import schedule_fleet, vectorized_search
    from repro_torch.kernels import build, cpm, ref
    from repro_torch.obs import Tracer
    from repro_torch.online import OnlineScheduler, production_arrivals

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(card, flush=True)
    emit("versions", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    # -- 0. build -------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_cpm()
    ptxas = [ln.strip() for ln in build.build_log().splitlines() if "Used" in ln]
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    # -- 1. kernels against their plain versions ------------------------------
    rng = np.random.default_rng(0)
    shapes = [
        ("offline", 16 * 8192, 16, 9),
        ("serving", 8 * 512, 16, 9),
        ("ragged8", 257, 8, None),
        ("ragged12", 257, 12, None),
        ("ragged128", 257, 128, None),
    ]
    max_err = {k: 0.0 for k in cpm.launches}
    table = {}
    for label, B, n, n_iters in shapes:
        w, p, extra, mask = lb_inputs(np, torch, rng, B, n)
        it = ref.clamp_iters(n, n_iters)
        calls = {
            "combined_lb": (
                lambda: cpm.batched_combined_lb(w, p, extra, n_iters=it),
                lambda: ref.ref_combined_lb(w, p, extra, n_iters=it),
            ),
            "combined_lb_masked": (
                lambda: cpm.batched_combined_lb(w, p, extra, mask=mask, n_iters=it),
                lambda: ref.ref_combined_lb(w, p, extra, mask=mask, n_iters=it),
            ),
            "critical_path": (
                lambda: cpm.batched_critical_path(w, n_iters=it),
                lambda: ref.ref_critical_path(w, n_iters=it),
            ),
        }
        for name, (kern, plain) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max().item())
            max_err[name] = max(max_err[name], err)
            check(torch.equal(got, want), f"{name} != plain at {label} (err {err})")
            ms = cuda_ms(torch, kern)
            plain_ms = cuda_ms(torch, plain, reps=5, warmup=1)
            b_ms, b_by = bound(B, n, it, name)
            emit("kernel", name=name, shape=label, B=B, n=n, n_iters=it, ms=ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
            if label == "offline":
                table[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by)
        del w, p, extra, mask
    torch.cuda.empty_cache()

    # -- main path: every count to 0 just before, read just after -------------
    for k in cpm.launches:
        cpm.launches[k] = 0
    t_main = time.perf_counter()

    # -- 2. offline fleet -------------------------------------------------------
    evs = production_arrivals(0, rate=1 / 60, n_jobs=16, n_racks=8, n_wireless=2)
    insts = [e.inst for e in evs]

    def fleet_run(instances, label):
        before = dict(cpm.launches)
        tr = Tracer()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fleet = schedule_fleet(instances, tracer=tr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        s1 = [s.duration for s in tr.spans_named("stage1_launch")]
        s2 = [s.duration for s in tr.spans_named("stage2_launch")]
        emit("offline_fleet", arm=label, n_instances=len(instances),
             wall_s=wall, n_candidates=fleet.n_candidates,
             candidates_per_s=fleet.n_candidates / wall,
             n_pruned=fleet.n_pruned, n_evaluated=fleet.n_evaluated,
             stage1_launches=fleet.n_stage1_launches,
             stage2_launches=fleet.n_stage2_launches,
             stage1_ms_per_launch=1e3 * float(np.mean(s1)) if s1 else None,
             stage2_ms_per_launch=1e3 * float(np.mean(s2)) if s2 else None,
             stage2_rows=8192 * len(instances),
             kernel_launches={k: cpm.launches[k] - before[k] for k in before},
             makespans=[float(m) for m in fleet.makespans])
        for inst, res in zip(instances, fleet.results):
            check_feasible(inst, res.schedule)
        return fleet, {k: cpm.launches[k] - before[k] for k in before}, wall

    def same(a, b):
        return (a.makespan == b.makespan
                and np.array_equal(a.best_assignment, b.best_assignment)
                and a.n_candidates == b.n_candidates
                and a.n_pruned == b.n_pruned and a.n_evaluated == b.n_evaluated
                and a.refine_rounds == b.refine_rounds)

    fleet, d, fleet_wall = fleet_run(insts, "plain")
    check(d["combined_lb"] > 0, "offline fleet launched no combined_lb")
    for i, inst in enumerate(insts):
        check(same(vectorized_search(inst), fleet.results[i]),
              f"offline fleet != solo for instance {i}")

    topo_rng = np.random.default_rng(1)
    topo_insts = [
        dataclasses.replace(
            inst,
            topology=Topology(
                reach=topo_rng.random((inst.n_racks, inst.n_wireless)) < 0.5
            ),
        )
        for inst in insts
    ]
    tfleet, d, _ = fleet_run(topo_insts, "topology")
    check(d["combined_lb_masked"] > 0, "topology fleet launched no masked kernel")
    for i in range(4):
        check(same(vectorized_search(topo_insts[i]), tfleet.results[i]),
              f"topology fleet != solo for instance {i}")

    for sub in (insts[:4], topo_insts[:4]):
        gpu = schedule_fleet(sub, batch_size=2048)
        cpu = schedule_fleet(sub, batch_size=2048, device="cpu")
        for a, b in zip(gpu.results, cpu.results):
            check(same(a, b), "card != CPU on the 4-instance subset")
    emit("card_equals_cpu", instances=4, batch_size=2048, arms=2)

    # -- 3. serving ---------------------------------------------------------
    golden_evs = production_arrivals(3, rate=1 / 10, n_jobs=5, n_racks=6,
                                     n_wireless=2)
    res = OnlineScheduler(
        6, 2, window=5.0, seed=3,
        solver_kwargs=dict(max_enumerate=64, n_samples=64, batch_size=256,
                           refine_rounds=1, refine_pool=64),
    ).serve(golden_evs)
    rows = [(m.job_id, m.admitted, m.completion, m.makespan,
             m.n_racks_granted, m.n_wireless_granted) for m in res.jobs]
    check(rows == GOLDEN_FLEET_ROWS, "production_fleet fingerprint differs")
    check(dict(n_epochs=res.n_epochs, n_served=res.n_served,
               n_backfilled=res.n_backfilled, horizon=res.horizon)
          == GOLDEN_FLEET_COUNTERS, "production_fleet counters differ")
    emit("serve_golden", fingerprint_equal=True, n_served=res.n_served)

    stream = production_arrivals(0, rate=1 / 60, n_jobs=SERVE_JOBS, n_racks=8,
                                 n_wireless=2)

    def serve(label, **kw):
        before = dict(cpm.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        # serve() ends with the timeline's feasibility audit
        # (ClusterTimeline.assert_feasible), which raises on any overlap.
        out = OnlineScheduler(8, 2, window=5.0, seed=0, **kw).serve(stream)
        wall = time.perf_counter() - t
        launched = {k: cpm.launches[k] - before[k] for k in before}
        check(out.n_served == SERVE_JOBS, f"{label}: served {out.n_served}")
        check(np.isfinite(out.mean_jct), f"{label}: mean JCT not finite")
        emit("serve", arm=label, n_jobs=SERVE_JOBS, n_served=out.n_served,
             wall_s=wall, mean_jct=out.mean_jct, p99_jct=out.p99_jct,
             n_epochs=out.n_epochs, solver_wall_s=out.solver_wall,
             solver_wall_per_epoch_s=out.solver_wall / out.n_epochs,
             n_solves=out.n_solves, n_candidates=out.n_candidates,
             n_pruned=out.n_pruned, n_reconfigs=out.n_reconfigs,
             kernel_launches=launched)
        return launched

    d = serve("fleet")
    check(d["combined_lb"] > 0, "fleet serve launched no combined_lb")
    d = serve("matching", topology="matching",
              cluster_topology=Topology(reach=np.ones((8, 2), bool), degree=1,
                                        delta=0.5))
    check(d["combined_lb_masked"] > 0, "matching serve launched no masked kernel")

    main_launches = dict(cpm.launches)
    emit("main_path", seconds=time.perf_counter() - t_main,
         launches=main_launches)
    for name in ("combined_lb", "combined_lb_masked"):
        check(main_launches[name] > 0, f"main path never launched {name}")

    # -- 4. where the device time goes (after the main-path counts) ----------
    # The offline fleet and the first PROFILE_JOBS jobs of the serving
    # stream again under torch.profiler: device time by kernel name, the
    # device's busy share of the unprofiled wall time of the same work, and
    # the kernel count. (A full 200-job serve records too many events.)
    profile_run("offline_fleet", lambda: schedule_fleet(insts), fleet_wall)
    short = stream[:PROFILE_JOBS]

    def serve_short():
        return OnlineScheduler(8, 2, window=5.0, seed=0).serve(short)

    torch.cuda.synchronize()
    t = time.perf_counter()
    serve_short()
    torch.cuda.synchronize()
    profile_run(f"serve_{PROFILE_JOBS}_jobs", serve_short, time.perf_counter() - t)

    kernels = [
        dict(name=name, route="cuda", source=KERNEL_SOURCE,
             replaces=REPLACES[name], launches=main_launches[name],
             max_abs_err=max_err[name], ms=table[name]["ms"],
             plain_ms=table[name]["plain_ms"], bound_ms=table[name]["bound_ms"],
             bound_by=table[name]["bound_by"], library_ms=None)
        for name in ("combined_lb", "combined_lb_masked", "critical_path")
    ]
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
