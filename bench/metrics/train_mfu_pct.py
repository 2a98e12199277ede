"""The whole training step's model flops (6 x active matmul parameters x
tokens, and the causal attention's forward and backward, no recompute)
over the window's time, as a share of the H100's bf16 peak."""

from bench.harness import readings


def read(r: dict) -> float | None:
    return readings.mfu_pct(r, "train")
