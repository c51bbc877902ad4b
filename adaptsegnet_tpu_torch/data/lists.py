"""Devkit list files and synthetic GTA5 / Cityscapes fixtures
(counterpart of adaptsegnet_tpu/data/lists.py; the fixtures make the same
files from the same seeds).
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
from PIL import Image

from adaptsegnet_tpu_torch.data.preprocessing import (
    CLASS_NAMES,
    GTA5_ID_TO_TRAINID,
)


def cityscapes_label2train() -> list[list[int]]:
    """info.json label2train: raw ids 0..33 and -1; the 19 eval classes map
    to train ids, everything else to 255 (compute_iou.py:35-40)."""
    return [[raw, GTA5_ID_TO_TRAINID.get(raw, 255)]
            for raw in list(range(34)) + [-1]]


def write_devkit(devkit_dir: str, val_names: list[str], label_names: list[str]):
    """Write val.txt / label.txt / info.json in the reference devkit layout."""
    os.makedirs(devkit_dir, exist_ok=True)
    with open(osp.join(devkit_dir, "val.txt"), "w") as f:
        f.write("\n".join(val_names) + "\n")
    with open(osp.join(devkit_dir, "label.txt"), "w") as f:
        f.write("\n".join(label_names) + "\n")
    info = {
        "classes": 19,
        "label": CLASS_NAMES,
        "label2train": cityscapes_label2train(),
    }
    with open(osp.join(devkit_dir, "info.json"), "w") as f:
        json.dump(info, f)


def make_synthetic_gta5(root: str, n: int = 4, size_wh=(64, 32), seed=0) -> str:
    """Write a tiny GTA5-layout dataset (images/, labels/ of raw ids);
    returns the list file path."""
    rng = np.random.default_rng(seed)
    os.makedirs(osp.join(root, "images"), exist_ok=True)
    os.makedirs(osp.join(root, "labels"), exist_ok=True)
    names = []
    raw_ids = np.array(sorted(GTA5_ID_TO_TRAINID) + [0, 1, 4])
    for i in range(n):
        name = f"{i:05d}.png"
        img = rng.integers(0, 256, size=(size_wh[1], size_wh[0], 3), dtype=np.uint8)
        lab = raw_ids[rng.integers(0, len(raw_ids), size=(size_wh[1], size_wh[0]))]
        Image.fromarray(img).save(osp.join(root, "images", name))
        Image.fromarray(lab.astype(np.uint8)).save(osp.join(root, "labels", name))
        names.append(name)
    list_path = osp.join(root, "train.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(names) + "\n")
    return list_path


def make_synthetic_cityscapes(
    root: str, split: str = "train", n: int = 4, size_wh=(64, 32), seed=1
) -> str:
    """Write a tiny Cityscapes-layout image set; returns the list file path."""
    rng = np.random.default_rng(seed)
    base = osp.join(root, "leftImg8bit", split, "synthcity")
    os.makedirs(base, exist_ok=True)
    names = []
    for i in range(n):
        name = f"synthcity/synthcity_{i:06d}_leftImg8bit.png"
        img = rng.integers(0, 256, size=(size_wh[1], size_wh[0], 3), dtype=np.uint8)
        Image.fromarray(img).save(osp.join(root, "leftImg8bit", split, name))
        names.append(name)
    list_path = osp.join(root, f"{split}.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(names) + "\n")
    return list_path


def make_synthetic_cityscapes_gt(
    root: str, names: list[str], size_wh=(64, 32), seed=2
):
    """Write gtFine-style label PNGs (raw ids) for the given val names."""
    rng = np.random.default_rng(seed)
    gt_dir = osp.join(root, "gtFine", "val")
    os.makedirs(gt_dir, exist_ok=True)
    label_names = []
    raw_ids = np.array(sorted(GTA5_ID_TO_TRAINID) + [0, 3, 4])
    for name in names:
        base = osp.basename(name).replace(
            "_leftImg8bit.png", "_gtFine_labelIds.png"
        )
        lab = raw_ids[rng.integers(0, len(raw_ids), size=(size_wh[1], size_wh[0]))]
        Image.fromarray(lab.astype(np.uint8)).save(osp.join(gt_dir, base))
        label_names.append(base)
    return gt_dir, label_names
