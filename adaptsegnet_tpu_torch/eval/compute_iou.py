"""Offline mIoU over prediction PNGs (reference compute_iou.py:31-65).

Reads the devkit (info.json: classes/label/label2train; val.txt/label.txt
file lists), remaps ground-truth raw ids to train ids, accumulates the
confusion matrix, prints and returns per-class IoU.
"""

from __future__ import annotations

import json
from os.path import join

import numpy as np
from PIL import Image

from adaptsegnet_tpu_torch.ops.metrics import (
    fast_hist,
    label_mapping,
    mean_iou,
    per_class_iu,
)


def compute_mIoU(
    gt_dir: str,
    pred_dir: str,
    devkit_dir: str = "",
    verbose: bool = True,
) -> np.ndarray:
    """Reference-parity mIoU: returns per-class IoU array, prints the mean."""
    with open(join(devkit_dir, "info.json")) as fp:
        info = json.load(fp)
    num_classes = int(info["classes"])
    name_classes = list(info["label"])
    mapping = np.array(info["label2train"], dtype=np.int64)
    hist = np.zeros((num_classes, num_classes), dtype=np.float64)

    with open(join(devkit_dir, "label.txt")) as f:
        gt_imgs = [join(gt_dir, x) for x in f.read().splitlines()]
    with open(join(devkit_dir, "val.txt")) as f:
        pred_imgs = [join(pred_dir, x.split("/")[-1])
                     for x in f.read().splitlines()]

    for gt_path, pred_path in zip(gt_imgs, pred_imgs):
        pred = np.array(Image.open(pred_path))
        label = label_mapping(np.array(Image.open(gt_path)), mapping)
        if label.size != pred.size:
            if verbose:
                print(
                    "Skipping: len(gt) = {:d}, len(pred) = {:d}, {:s}, {:s}".format(
                        label.size, pred.size, gt_path, pred_path
                    )
                )
            continue
        hist += fast_hist(label.flatten(), pred.flatten(), num_classes)

    ious = per_class_iu(hist)
    if verbose:
        for name, iou in zip(name_classes, ious):
            print("===>" + name + ":\t" + str(round(float(iou) * 100, 2)))
        print("===> mIoU: " + str(round(mean_iou(hist), 2)))
    return ious
