"""The port's flash forward kernel in prefill: every layer's least time at
each traced call's shape over the kernel's device time."""

from bench.harness import readings


def read(r: dict) -> float | None:
    return readings.attention_roofline_pct(r, "prefill")
