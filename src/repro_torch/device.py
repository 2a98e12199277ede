"""Device resolution for every entry point of the port.

Each public entry point takes ``device=None``. ``None`` means the CUDA
card. A CPU run has to be asked for by name (``device="cpu"``, as the
tests do); without a card every other request raises instead of quietly
falling back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (``None`` = ``"cuda"``).

    Raises ``RuntimeError`` when CUDA is requested (explicitly or by
    default) and no card is available, and ``ValueError`` for device types
    other than ``cpu`` and ``cuda``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
