"""Device selection: the port runs on a CUDA card unless told otherwise.

The card is the process's current CUDA device: card 0 in a single
process, the rank's card in a data-parallel group (parallel/group.py sets
it before anything touches the card)."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The current CUDA device (the rank's card); raises when there is none
    (no silent CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --cpu on "
            "the command line) to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`None` -> default_device(); otherwise the named device, checked."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return default_device()  # raises with the message above
    return device
