"""Host ms from a prefill call's start to the program's return, before the
sync (the median over the window)."""

from bench.harness import readings


def read(r: dict) -> float | None:
    return readings.enqueue_ms(r, "prefill")
