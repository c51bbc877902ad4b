"""Pixel-exact image preprocessing (copy of adaptsegnet_tpu/data/preprocessing.py
for the eval slice; the port imports nothing of the JAX package).

Reference dataset/gta5_dataset.py: images resized with PIL BICUBIC to
crop_size given as (W, H) (:55-56), RGB -> BGR (:67), minus the Caffe BGR
mean (train_gta2cityscapes_multi.py:30). Output is HWC float32.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

# Caffe BGR mean (reference train_gta2cityscapes_multi.py:30).
IMG_MEAN_BGR = np.array(
    (104.00698793, 116.66876762, 122.67891434), dtype=np.float32
)

# GTA5 raw label id -> Cityscapes train id (reference gta5_dataset.py:28-30).
GTA5_ID_TO_TRAINID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}

# Cityscapes 19-class train-id names (order = train id).
CLASS_NAMES = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "light", "sign",
    "vegetation", "terrain", "sky", "person", "rider", "car", "truck", "bus",
    "train", "motocycle", "bicycle",
]


def load_image(path: str, crop_size_wh: tuple[int, int]) -> np.ndarray:
    """Decode + BICUBIC-resize an RGB image; returns HWC uint8-ranged f32 RGB."""
    img = Image.open(path).convert("RGB")
    img = img.resize(crop_size_wh, Image.BICUBIC)
    return np.asarray(img, np.float32)


def preprocess_image(img_rgb_hwc: np.ndarray,
                     mean_bgr: np.ndarray = IMG_MEAN_BGR) -> np.ndarray:
    """RGB HWC -> mean-subtracted BGR HWC float32."""
    bgr = img_rgb_hwc[:, :, ::-1].astype(np.float32)
    return np.ascontiguousarray(bgr - mean_bgr)
