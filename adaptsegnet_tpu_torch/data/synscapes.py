"""Synscapes source-domain dataset (counterpart of
adaptsegnet_tpu/data/synscapes.py).

Synscapes (arXiv:1810.08705) uses Cityscapes class ids directly, laid out as
<root>/img/rgb/<n>.png (RGB frames) and <root>/img/class/<n>.png (label PNGs
with Cityscapes raw ids). `list_path` names the frames, one per line; without
it every PNG under img/rgb is taken, sorted. The pipeline is GTA5Dataset's:
bicubic / nearest resize, BGR mean subtraction, and the same raw-id ->
train-id table, since Synscapes carries Cityscapes ids.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from adaptsegnet_tpu_torch.data import preprocessing as pp


class SynscapesDataset:
    def __init__(
        self,
        root: str,
        list_path: str | None = None,
        max_iters: int | None = None,
        crop_size: tuple[int, int] = (1024, 512),  # (W, H)
        mean: np.ndarray = pp.IMG_MEAN_BGR,
        scale: bool = False,
        mirror: bool = False,
        ignore_label: int = 255,
        seed: int = 1338,
    ):
        self.root = root
        self.crop_size = crop_size
        self.mean = np.asarray(mean, np.float32)
        self.scale = scale
        self.mirror = mirror
        self.ignore_label = ignore_label
        self._rng = np.random.default_rng(seed)
        if list_path:
            with open(list_path) as f:
                names = [line.strip() for line in f if line.strip()]
        else:
            names = sorted(n for n in os.listdir(osp.join(root, "img", "rgb"))
                           if n.endswith(".png"))
        if max_iters is not None:
            names = names * int(np.ceil(float(max_iters) / len(names)))
        self.files = [{"img": osp.join(root, "img", "rgb", name),
                       "label": osp.join(root, "img", "class", name),
                       "name": name} for name in names]

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int):
        entry = self.files[index]
        crop = self.crop_size
        if self.scale:
            f = float(self._rng.uniform(0.75, 1.25))
            crop = (max(1, int(crop[0] * f)), max(1, int(crop[1] * f)))
        image = pp.load_image(entry["img"], crop)
        label = pp.remap_gta5_labels(pp.load_label(entry["label"], crop))
        image = pp.preprocess_image(image, self.mean)
        if self.mirror:
            image, label = pp.random_mirror([image, label], self._rng)
        size = np.array(image.shape, dtype=np.int64)
        return image, label, size, entry["name"]
