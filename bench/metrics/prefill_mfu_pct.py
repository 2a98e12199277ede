"""The prefill calls' model flops (2 x active matmul parameters x tokens,
and the causal attention's forward) over the window's time, as a share of
the H100's bf16 peak."""

from bench.harness import readings


def read(r: dict) -> float | None:
    return readings.mfu_pct(r, "prefill")
