"""Traffic kind "hybrid_prefill": the prefill traffic of
``bench.kinds.prefill`` (the same plan of lengths, prompts, sample and
warm-up) on a hybrid Mamba-1 / attention / MoE decoder (Jamba), with its
own weights (``bench.harness.hybrid_weights``) and reference
(``bench.reference.hybrid``).

Set-up refuses a program whose model has no Mamba-1 mixer: a program that
does not know the configuration's fields would build another model under
its name.

A traced run's second pass (host and device) is one call of each length
and runs under the program's own tracer (``repro_torch.obs.trace``), so
that the program's spans are in that profile: each device operation of
the pass is attributed to its call and to the spans open where it was
launched, and the pass's Mamba-1 scans on the kernel are counted. Its
readers weight each length as the traffic's cycle does, so that what
they read does not depend on the seed's draw of lengths. The first pass (the device alone) and the timed
window run with no program tracer.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from bench.harness import compare, hybrid_weights, trace
from bench.harness.context import Outcome, Run
from bench.harness.trace import Tracer
from bench.kinds.prefill import WARM_INDEX, Plan, sample

FAULTS = ("half_batch", "token_altered", "context_halved")

# The program's span around a Mamba-1 mixer and its counter of scans that
# took the CUDA kernel (repro_torch.models.ssm.MIXER, KERNEL_SCANS).
MAMBA_SPAN = "mamba.mixer"
KERNEL_SCANS = "mamba.kernel_scans"
# A call of the host pass, by its prompt length.
CALL_SPAN = "bench.call.S"


def _program(run: Run):
    from repro_torch.models.config import layer_kinds
    from repro_torch.models.lm import build_model
    from repro_torch.runtime.steps import build_prefill_step

    from bench.kinds.train import _model_config

    cfg = _model_config(run.sizes)
    if not any(mixer == "mamba1" for mixer, _ in layer_kinds(cfg)):
        raise RuntimeError(f"the program builds no Mamba-1 mixer for {cfg.name} "
                           f"(its layer kinds: {sorted(set(layer_kinds(cfg)))})")
    model = build_model(cfg)
    params = hybrid_weights.make(run.sizes, run.seed, run.device, torch.bfloat16)
    prefill = build_prefill_step(model)

    def call(tokens: torch.Tensor) -> tuple[torch.Tensor, float, torch.Tensor]:
        """(the served token of each prompt; the host's clock when the
        prefill call returned, before the sync; the last-position logits
        [B, V] the call returned), on the host."""
        if "half_batch" in run.faults:
            rows = (tokens.shape[0] + 1) // 2
            logits = prefill(params, {"tokens": tokens[:rows]})
            logits = torch.cat([logits, torch.zeros((tokens.shape[0] - rows,) + logits.shape[1:],
                                                    dtype=logits.dtype, device=logits.device)])
        elif "context_halved" in run.faults:  # each prompt's second half alone
            logits = prefill(params, {"tokens": tokens[:, tokens.shape[1] // 2:]})
        else:
            logits = prefill(params, {"tokens": tokens})
        enqueued = time.time()
        last = logits[:, -1]
        if "token_altered" in run.faults:  # the first prompt's answer, shifted by one token
            last = torch.cat([last[:1].roll(1, dims=-1), last[1:]])
        served = last.argmax(dim=-1)
        return served.cpu(), enqueued, last.cpu()

    return params, call


def reference_logits(run: Run, plan: Plan, calls: list, precs=("f32",)) -> dict:
    """{prec: [N, V]} last-position reference logits of ``calls``' prompts,
    from weights made again from the seed."""
    from bench.reference.hybrid import last_logits

    leaves = {path: hybrid_weights.make_leaf(run.sizes, run.seed, i, run.device, torch.bfloat16)
              for i, (path, _, _) in enumerate(hybrid_weights.leaf_specs(run.sizes))}
    prompts = [torch.from_numpy(plan.prompts(d["c"], d["S"])) for d in calls]
    out = last_logits(run.sizes, leaves, prompts, precs)
    return {p: torch.cat(v) for p, v in out.items()}


def launch_spans(prof, names: tuple, calls: str) -> dict:
    """Device seconds of a host-and-device profile's operations by the
    call they belong to: for each span whose name starts with ``calls`` (a
    call), ``""`` the device seconds of all the operations launched inside
    it, and each of ``names`` those launched while a span of that name was
    open too. An operation's launch is the runtime call of the same
    correlation id, or else the host operation its
    ``linked_correlation_id`` names."""
    from torch.autograd import DeviceType

    spans = {n: [] for n in names}
    windows = []
    runtime, ops, device = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            iv = (e.start_ns(), e.start_ns() + e.duration_ns())
            if e.name() in spans:
                spans[e.name()].append(iv)
            elif e.name().startswith(calls):
                windows.append(iv + (e.name(),))
            elif e.name().startswith("cuda"):
                runtime[e.correlation_id()] = e.start_ns()
            else:
                ops[e.correlation_id()] = e.start_ns()
        elif e.duration_ns() > 0 and not e.is_user_annotation() \
                and not e.name().startswith(trace.MARKS):
            device.append(e)
    starts = {n: sorted(v) for n, v in spans.items()}

    def inside(ivs, at) -> bool:
        i = bisect.bisect_right(ivs, (at, float("inf"))) - 1
        return i >= 0 and ivs[i][0] <= at <= ivs[i][1]

    out = {w[2]: dict.fromkeys(("",) + tuple(names), 0.0) for w in windows}
    for e in device:
        at = runtime.get(e.correlation_id(), ops.get(e.linked_correlation_id()))
        call = next((w[2] for w in windows if at is not None and w[0] <= at <= w[1]), None)
        if call is None:
            continue
        out[call][""] += e.duration_ns() / 1e9
        for n, ivs in starts.items():
            if inside(ivs, at):
                out[call][n] += e.duration_ns() / 1e9
    return out


@contextlib.contextmanager
def host_window(tracer: Tracer, run: Run, found: dict):
    """The harness's second pass (``Tracer.host_window``: host and device,
    inside the window mark) with the program's tracer installed; ``found``
    gets the pass's device seconds by call and span (:func:`launch_spans`,
    a call a ``CALL_SPAN`` span) and the program's counter of kernel
    scans."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.selective_scan import launches
    from repro_torch.obs.trace import Tracer as ProgramTracer
    from repro_torch.obs.trace import installed

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    program = ProgramTracer()
    before = launches["selective_scan"]
    run.sync()
    with installed(program), profile(activities=acts) as prof:
        with record_function(trace.WINDOW_MARK):
            yield
            run.sync()
    tracer.host_trace = trace.from_profile(prof)
    found["device_s"] = launch_spans(prof, (MAMBA_SPAN,), CALL_SPAN)
    found["kernel_scans"] = program.counter(KERNEL_SCANS)
    found["launches"] = launches["selective_scan"] - before


def execute(run: Run) -> Outcome:
    t = run.traffic
    plan = Plan(t, run.seed, run.sizes["vocab_size"])
    params, call = _program(run)
    for i, S in enumerate(t["seq_lens"]):
        call(torch.from_numpy(plan.prompts(WARM_INDEX + i, S)).to(run.device))
    run.sync()

    tracer = Tracer(run.sync)
    items = []
    w0 = time.time()
    setup_s = w0 - run.t0

    def one(traced: bool, kept: bool = True, S: int | None = None):
        c = len(items)
        S = S or plan.seq_len(c)
        with record_function("bench.feed"):
            host = torch.from_numpy(plan.prompts(c, S))
        a = time.time()
        tokens = host.to(run.device)
        served, e, logits = call(tokens)
        z = time.time()
        if kept:
            items.append({"c": c, "S": S, "B": host.shape[0], "tokens": host.numel(),
                          "enqueue_s": e - a, "latency_s": z - a, "served": served,
                          "logits": logits, "traced": traced})

    while time.time() - w0 < run.seconds:
        one(False)
    window_s = time.time() - w0
    spans: dict = {}
    if run.trace:  # after the timed part, so that the profiler's start falls outside it
        with tracer.window():
            for _ in range(t["trace_calls"]):
                one(True)
        with host_window(tracer, run, spans):
            for S in t["seq_lens"]:
                with record_function(f"{CALL_SPAN}{S}"):
                    one(False, kept=False, S=S)
        spans["calls"] = len(t["seq_lens"])
        spans["weights"] = {f"{CALL_SPAN}{S}": n for S, n in zip(t["seq_lens"], t["cycle"])}
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0

    picked = [items[i] for i in sample(items, run.seed, t["check_tokens"])]
    logits = torch.cat([d["logits"] for d in picked])
    for d in items:
        del d["logits"]
    del params, call
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    r0 = time.time()
    ref = reference_logits(run, plan, picked)["f32"]
    ref_s = time.time() - r0
    served = torch.cat([d["served"] for d in picked])
    numbers = dict(compare.served_gaps(ref, served), **compare.logit_errors(ref, logits))
    timed = [d for d in items if not d["traced"]]
    lat = np.array([d["latency_s"] for d in timed])
    detail = {"checked_calls": len(picked), "checked_tokens": int(served.numel()),
              "reference_s": ref_s}
    if spans:
        detail["kernel_scans_per_call"] = spans["kernel_scans"] / spans["calls"]
        detail["scan_launches_per_call"] = spans["launches"] / spans["calls"]
    return Outcome(
        attempted=len(items), failed=0,
        e2e={"setup_s": setup_s,
             "prefill_tokens_per_s": sum(d["tokens"] for d in timed) / window_s,
             "prefill_p95_ms": float(np.percentile(lat, 95)) * 1e3},
        reading={"kind": "prefill", "sizes": run.sizes, "items": items, "window_s": window_s,
                 "trace": tracer.trace, "host_trace": tracer.host_trace, "peak_bytes": peak,
                 "spans": spans or None},
        numbers=numbers, peak_bytes=peak, detail=detail)
