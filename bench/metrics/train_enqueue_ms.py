"""Host ms from a training step's call to its return, before the sync (the
median over the window)."""

from bench.harness import readings


def read(r: dict) -> float | None:
    return readings.enqueue_ms(r, "train")
