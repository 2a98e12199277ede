"""Device ms a traced training step of every kernel that is neither a
matrix product nor the port's attention: models/lm.py's eager ops and
optim/adamw.py."""

from bench.harness import readings


def read(r: dict) -> float | None:
    return readings.kernel_ms(r, "train", "other")
