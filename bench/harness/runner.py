"""One run of one cell, from ``BENCHMARK.json``'s names to the result's
line: the module of the cell's traffic kind runs the program and the
reference, the per-layer readers read what it recorded, and the compared
numbers are judged against the cell's limits."""

from __future__ import annotations

from bench.harness import compare, registry, trace
from bench.harness.context import Run


def make_run(bench: dict, workload: str, seed: int, seconds: float, trace_on: bool,
             device, t0: float, faults=frozenset(), cfg: dict | None = None,
             traffic: dict | None = None) -> Run:
    """The cell's run; ``cfg`` and ``traffic`` replace the cell's files
    (tests at a size the CPU holds)."""
    cell = registry.cell(bench, workload)
    cfg = cfg or registry.config(bench, cell["config"])
    return Run(workload=workload, cfg=cfg, sizes=registry.port_sizes(cfg),
               traffic=traffic or registry.traffic(cell["traffic"]), seed=int(seed),
               seconds=float(seconds), trace=bool(trace_on), device=device, t0=t0,
               faults=frozenset(faults))


def device_info(run: Run, chips: int, peak: int) -> dict:
    import torch

    if getattr(run.device, "type", str(run.device)) == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": int(peak)}


def execute(bench: dict, run: Run, limits: dict | None = None) -> dict:
    """The result's object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with a trace ``breakdown``, and ``checks``
    last; ``limits`` replace the cell's limits file."""
    cell = registry.cell(bench, run.workload)
    module = registry.kind(run.traffic["kind"])
    out = module.execute(run)
    lim = limits or compare.limits(run.workload)
    ok, checks = compare.judge(out.numbers, lim)
    metrics = {}
    for m in registry.metrics_for(bench, run.workload, run.trace):
        if run.trace:
            value = registry.reader(m["name"])(out.reading)
        else:
            value = out.e2e[m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = device_info(run, cell["chips"], out.peak_bytes)
    result = {"correct": bool(ok and out.failed == 0), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    tr = out.reading.get("trace")
    if run.trace and tr is not None:
        device["busy_s"] = trace.busy_s(tr)
        device["window_s"] = tr.window_s
        host = out.reading.get("host_trace") or tr
        result["breakdown"] = {"device_ops": trace.top_ops(tr),
                               "idle_gaps": trace.idle_gaps(host)}
    result["detail"] = dict(out.detail, e2e=out.e2e, numbers=out.numbers)
    result["checks"] = checks
    return result
