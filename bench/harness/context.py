"""What a traffic kind's module is given (:class:`Run`) and what it hands
back (:class:`Outcome`)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Run:
    """One run of one cell. ``t0``: the process's start on ``time.time()``.
    ``faults``: faults planted in the program's path by a test or the
    calibration (names in each kind module's ``FAULTS``); a benchmark run has
    none. ``reference``: the reference's readings of this seed, where
    the calibration has them already (the run then skips the reference)."""

    workload: str
    cfg: dict
    sizes: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    faults: frozenset = frozenset()
    reference: dict | None = None

    def sync(self) -> None:
        import torch

        if getattr(self.device, "type", str(self.device)) == "cuda":
            torch.cuda.synchronize()


@dataclasses.dataclass
class Outcome:
    """A kind module's result. ``e2e``: end-to-end metric values by name.
    ``reading``: what the per-layer readers read (``bench.metrics``).
    ``numbers``: the compared numbers by name; ``detail``: where each
    came from (printed, not judged)."""

    attempted: int
    failed: int
    e2e: dict
    reading: dict
    numbers: dict
    peak_bytes: int
    detail: dict = dataclasses.field(default_factory=dict)
    ref: dict | None = None  # the reference's readings (training)
