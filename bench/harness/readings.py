"""Reductions the per-layer readers (``bench/metrics``) share. A reading
is what a traffic kind's module recorded (``Outcome.reading``): its
traffic ``kind``, the
port's ``sizes``, the window's ``items`` (steps or calls: rows ``B``,
length ``S``, ``tokens``, ``enqueue_s``, ``latency_s``, ``traced``), the
window's ``window_s``, the ``trace`` of its traced items (the device
alone), the ``host_trace`` of a few more (host and device; it only names
the idle gaps) and the ``peak_bytes``. A reader returns None where it has nothing to read."""

from __future__ import annotations

import statistics

from bench.harness import flops, kernels, trace


def _traced(r: dict, kind: str):
    """(trace, traced items) of a ``kind`` reading, or None."""
    if r.get("kind") != kind or r.get("trace") is None:
        return None
    items = [i for i in r["items"] if i["traced"]]
    return (r["trace"], items) if items else None


def kernel_ms(r: dict, kind: str, what: str) -> float | None:
    """Device ms a traced item of the kernels of kind ``what``
    (``bench.harness.kernels.kind``)."""
    got = _traced(r, kind)
    if got is None:
        return None
    tr, items = got
    return 1e3 * sum(d for n, _, d in tr.clipped() if kernels.kind(n) == what) / len(items)


def idle_pct(r: dict, kind: str) -> float | None:
    got = _traced(r, kind)
    if got is None:
        return None
    tr = got[0]
    return 100.0 * (1.0 - trace.busy_s(tr) / tr.window_s)


def enqueue_ms(r: dict, kind: str) -> float | None:
    """Median host ms from a step's or call's start to the program's
    return, before the sync, over the window."""
    if r.get("kind") != kind or not r["items"]:
        return None
    return 1e3 * statistics.median(i["enqueue_s"] for i in r["items"])


def mfu_pct(r: dict, kind: str) -> float | None:
    """Model flops of the timed window's items over its time, as a share of
    the bf16 peak (a traced run's traced items come after that window)."""
    items = [i for i in r.get("items", []) if not i["traced"]]
    if r.get("kind") != kind or not items:
        return None
    count = flops.train_step_flops if kind == "train" else flops.prefill_flops
    total = sum(count(r["sizes"], i["B"], i["S"]) for i in items)
    return 100.0 * total / r["window_s"] / flops.BF16_OPS_PER_S


def attention_roofline_pct(r: dict, kind: str) -> float | None:
    """The least time of the traced attention kernels over their device
    time. Training: each launch's bound at the micro-batch's shape, by
    the launches of each kernel in the trace. Prefill: the forward's bound
    of every layer of every traced call, at the call's shape."""
    got = _traced(r, kind)
    if got is None:
        return None
    tr, items = got
    m = r["sizes"]
    H, KV, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    timed = [(kernels.attention_kind(n), d) for n, _, d in tr.clipped()]
    timed = [(k, d) for k, d in timed if k is not None]
    busy = sum(d for _, d in timed)
    if not busy:
        return None
    if kind == "train":
        b = items[0]["B"] // r["n_micro"]
        bounds = flops.flash_bounds(b, items[0]["S"], H, KV, D)
        need = sum(bounds["fwd_lse" if k == "fwd" else k] for k, _ in timed)
    else:
        need = sum(m["n_layers"] * flops.flash_bounds(i["B"], i["S"], H, KV, D)["fwd"]
                   for i in items)
    return 100.0 * need / busy
