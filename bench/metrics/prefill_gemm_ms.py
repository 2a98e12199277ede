"""Device ms a traced prefill call of the library's matrix products
(models/layers.py projections and MLP, models/moe.py's expert products)."""

from bench.harness import readings


def read(r: dict) -> float | None:
    return readings.kernel_ms(r, "prefill", "gemm")
