"""Pixel-exact preprocessing (copy of adaptsegnet_tpu/data/preprocessing.py;
the port imports nothing of the JAX package).

Reference dataset/gta5_dataset.py: images resized with PIL BICUBIC and
labels with NEAREST to crop_size given as (W, H) (:55-56), RGB -> BGR (:67),
minus the Caffe BGR mean (train_gta2cityscapes_multi.py:30); GTA5 raw ids
remapped to the 19 Cityscapes train ids, everything else to 255 (:28-30,
62-64). Output is HWC float32.
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


IGNORE_LABEL = 255


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


def load_label(path: str, crop_size_wh: tuple[int, int]) -> np.ndarray:
    """Decode + NEAREST-resize a label PNG; returns HW f32 of raw ids."""
    lab = Image.open(path)
    lab = lab.resize(crop_size_wh, Image.NEAREST)
    return np.asarray(lab, np.float32)


def remap_gta5_labels(label: np.ndarray) -> np.ndarray:
    """Raw GTA5 ids -> train ids with 255 ignore (gta5_dataset.py:62-64)."""
    out = np.full(label.shape, IGNORE_LABEL, dtype=np.float32)
    for k, v in GTA5_ID_TO_TRAINID.items():
        out[label == k] = v
    return out


def random_mirror(arrays: list[np.ndarray], rng: np.random.Generator):
    """Horizontal flip applied jointly (opt-in; the reference accepts the
    flag but never applies it, gta5_dataset.py:14 vs :47-71)."""
    if rng.random() < 0.5:
        return [np.ascontiguousarray(a[:, ::-1]) for a in arrays]
    return arrays
