"""Scalar logging: the reference's print format, and optional tensorboardX.

Counterpart of adaptsegnet_tpu/utils/logging.py (reference
train_gta2cityscapes_multi.py:301-302, 477-480, 699-703): per-iteration loss
lines, and with --tensorboard the scalars every 10 iterations (:292-299,
:466-475, :685-697). `tensorboardX` is imported only when the flag asks for
it.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional


class ScalarLogger:
    def __init__(self, log_dir: Optional[str] = None, tensorboard: bool = False,
                 every: int = 10):
        self._writer = None
        self._every = every
        if tensorboard and log_dir:
            os.makedirs(log_dir, exist_ok=True)
            from tensorboardX import SummaryWriter

            self._writer = SummaryWriter(log_dir)

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        if self._writer is not None and step % self._every == 0:
            for key, val in scalars.items():
                self._writer.add_scalar(key, float(val), step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


def format_losses(i_iter: int, num_steps: int,
                  scalars: Mapping[str, float]) -> str:
    """Reference-style progress line."""
    parts = " ".join(f"{k} = {float(v):.3f}" for k, v in scalars.items())
    return f"iter = {i_iter:8d}/{num_steps:8d}, {parts}"
