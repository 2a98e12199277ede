"""Device ms a traced training step of the library's matrix products
(models/layers.py projections and MLP, the loss's logits)."""

from bench.harness import readings


def read(r: dict) -> float | None:
    return readings.kernel_ms(r, "train", "gemm")
