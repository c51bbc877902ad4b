"""GTA5 source-domain dataset (counterpart of adaptsegnet_tpu/data/gta5.py).

Reference dataset/gta5_dataset.py. Layout <root>/images/<name> (RGB) and
<root>/labels/<name> (raw-id PNGs), `list_path` one name per line, repeated
to cover `max_iters` items (:24-25). Returns (image HWC f32 BGR
mean-subtracted, label HW f32 train ids, size (h, w, c), name) (:71).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from adaptsegnet_tpu_torch.data import preprocessing as pp


class GTA5Dataset:
    def __init__(
        self,
        root: str,
        list_path: str,
        max_iters: int | None = None,
        crop_size: tuple[int, int] = (321, 321),  # (W, H), torch-style
        mean: np.ndarray = pp.IMG_MEAN_BGR,
        scale: bool = False,
        mirror: bool = False,
        seed: int = 1338,
    ):
        self.crop_size = crop_size
        self.mean = np.asarray(mean, np.float32)
        self.scale = scale
        self.mirror = mirror
        self._rng = np.random.default_rng(seed)
        with open(list_path) as f:
            names = [line.strip() for line in f if line.strip()]
        if max_iters is not None:
            names = names * int(np.ceil(float(max_iters) / len(names)))
        self.files = [{"img": osp.join(root, "images", name),
                       "label": osp.join(root, "labels", name), "name": name}
                      for name in names]

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int):
        entry = self.files[index]
        crop = self.crop_size
        if self.scale:
            # Opt-in scale jitter of the crop by [0.75, 1.25], as the JAX
            # package's (the reference flag is dead).
            f = float(self._rng.uniform(0.75, 1.25))
            crop = (max(1, int(crop[0] * f)), max(1, int(crop[1] * f)))
        image = pp.load_image(entry["img"], crop)
        label = pp.remap_gta5_labels(pp.load_label(entry["label"], crop))
        image = pp.preprocess_image(image, self.mean)
        if self.mirror:
            image, label = pp.random_mirror([image, label], self._rng)
        size = np.array(image.shape, dtype=np.int64)
        return image, label, size, entry["name"]
