"""Cityscapes dataset (counterpart of adaptsegnet_tpu/data/cityscapes.py).

Images under <root>/leftImg8bit/<set>/<name>; `__getitem__` returns the
reference's 3-tuple (image HWC f32 BGR mean-subtracted, size, name)
(evaluate_cityscapes.py:158, train_gta2cityscapes_multi.py:418). For
training, the list repeats to cover `max_iters` items and `mirror` flips
at random.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from adaptsegnet_tpu_torch.data import preprocessing as pp


class CityscapesDataset:
    def __init__(
        self,
        root: str,
        list_path: str,
        crop_size: tuple[int, int] = (1024, 512),  # (W, H)
        set: str = "val",
        max_iters: int | None = None,
        mirror: bool = False,
        seed: int = 1338,
    ):
        self.crop_size = crop_size
        self.mirror = mirror
        self._rng = np.random.default_rng(seed)
        with open(list_path) as f:
            names = [line.strip() for line in f if line.strip()]
        if max_iters is not None:
            names = names * int(np.ceil(float(max_iters) / len(names)))
        self.files = [
            {"img": osp.join(root, "leftImg8bit", set, name), "name": name}
            for name in names
        ]

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int):
        entry = self.files[index]
        image = pp.load_image(entry["img"], self.crop_size)
        image = pp.preprocess_image(image)
        if self.mirror:
            (image,) = pp.random_mirror([image], self._rng)
        size = np.array(image.shape, dtype=np.int64)
        return image, size, entry["name"]
