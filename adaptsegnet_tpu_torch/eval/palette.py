"""Cityscapes 19-class color palette (reference evaluate_cityscapes.py:47-60)."""

from __future__ import annotations

import numpy as np
from PIL import Image

CITYSCAPES_PALETTE = [
    128, 64, 128, 244, 35, 232, 70, 70, 70, 102, 102, 156, 190, 153, 153,
    153, 153, 153, 250, 170, 30, 220, 220, 0, 107, 142, 35, 152, 251, 152,
    70, 130, 180, 220, 20, 60, 255, 0, 0, 0, 0, 142, 0, 0, 70, 0, 60, 100,
    0, 80, 100, 0, 0, 230, 119, 11, 32,
]
_PALETTE_FULL = CITYSCAPES_PALETTE + [0] * (256 * 3 - len(CITYSCAPES_PALETTE))


def colorize_mask(mask: np.ndarray) -> Image.Image:
    """uint8 train-id mask -> palettized PIL image."""
    img = Image.fromarray(mask.astype(np.uint8)).convert("P")
    img.putpalette(_PALETTE_FULL)
    return img
