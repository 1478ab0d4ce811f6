"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
missing CUDA device is an error, never a silent move to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def device_of(module: torch.nn.Module) -> torch.device:
    """The device of ``module``'s first parameter."""
    return next(module.parameters()).device
