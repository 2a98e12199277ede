"""The port's attention kernels in training (flash forward with lse,
delta, dk/dv, dq): the sum of each launch's least time over their device
time."""

from bench.harness import readings


def read(r: dict) -> float | None:
    return readings.attention_roofline_pct(r, "train")
