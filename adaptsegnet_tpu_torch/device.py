"""Device selection: the port runs on a CUDA card unless told otherwise."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The first CUDA device; raises when there is none (no silent CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --cpu on "
            "the command line) to run on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`None` -> default_device(); otherwise the named device, checked."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return default_device()  # raises with the message above
    return device
