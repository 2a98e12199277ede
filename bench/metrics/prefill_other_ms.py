"""Device ms a traced prefill call of every kernel that is neither a
matrix product nor the port's attention: models/moe.py's routing, dispatch
and combine, norms, RoPE."""

from bench.harness import readings


def read(r: dict) -> float | None:
    return readings.kernel_ms(r, "prefill", "other")
