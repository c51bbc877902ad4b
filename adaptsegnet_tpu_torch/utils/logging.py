"""Scalar logging in the reference's print format.

Counterpart of adaptsegnet_tpu/utils/logging.py (reference
train_gta2cityscapes_multi.py:301-302, 477-480, 699-703). The tensorboard
writer is not ported yet (train/config.py raises on --tensorboard), so
`ScalarLogger` keeps the interface and records nothing.
"""

from __future__ import annotations

from typing import Mapping, Optional


class ScalarLogger:
    def __init__(self, log_dir: Optional[str] = None, tensorboard: bool = False,
                 every: int = 10):
        if tensorboard:
            raise NotImplementedError(
                "--tensorboard is not ported yet: see ROADMAP.md")
        self.log_dir, self.every = log_dir, every

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        pass

    def close(self) -> None:
        pass


def format_losses(i_iter: int, num_steps: int,
                  scalars: Mapping[str, float]) -> str:
    """Reference-style progress line."""
    parts = " ".join(f"{k} = {float(v):.3f}" for k, v in scalars.items())
    return f"iter = {i_iter:8d}/{num_steps:8d}, {parts}"
