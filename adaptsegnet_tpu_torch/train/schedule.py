"""Polynomial LR decay (reference train_gta2cityscapes_multi.py:162-177).

Counterpart of adaptsegnet_tpu/train/schedule.py::lr_poly, computed in f32
as the JAX package computes it."""

from __future__ import annotations

import numpy as np


def lr_poly(base_lr: float, step: int, max_steps: int,
            power: float = 0.9) -> float:
    """base_lr * (1 - step / max_steps) ** power, clamped at 0, in f32.

    Applied per outer iteration, counted from 0 (the optax schedule's count
    of updates applied so far)."""
    frac = np.float32(1.0) - np.float32(step) / np.float32(max_steps)
    lr = np.float32(base_lr) * np.power(np.maximum(frac, np.float32(0.0)),
                                        np.float32(power))
    return float(lr)
