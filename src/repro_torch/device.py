"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for the CPU: ``None`` means
    ``cuda``, and a machine without CUDA raises instead of quietly running
    on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless device='cpu' is "
            "passed, and torch.cuda.is_available() is False")
    return dev
