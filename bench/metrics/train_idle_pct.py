"""The share of the traced training window in which no operation ran on
the device."""

from bench.harness import readings


def read(r: dict) -> float | None:
    return readings.idle_pct(r, "train")
