"""Confusion-matrix mIoU (reference compute_iou.py:15-65).

Counterpart of adaptsegnet_tpu/ops/metrics.py. The numpy `fast_hist`
serves the offline PNG pipeline; `fast_hist_torch` accumulates on the
device with `torch.bincount` in int64, so counts cannot overflow.
"""

from __future__ import annotations

import numpy as np
import torch


def fast_hist(label: np.ndarray, pred: np.ndarray, num_classes: int) -> np.ndarray:
    """NumPy confusion matrix; rows = ground truth, columns = prediction.
    Pixels whose label is outside [0, num_classes) are dropped."""
    label = np.asarray(label).reshape(-1)
    pred = np.asarray(pred).reshape(-1)
    k = (label >= 0) & (label < num_classes)
    return np.bincount(
        num_classes * label[k].astype(int) + pred[k],
        minlength=num_classes ** 2,
    ).reshape(num_classes, num_classes)


def fast_hist_torch(label: torch.Tensor, pred: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """Device confusion matrix (num_classes, num_classes) int64.

    label, pred: integer tensors of one shape. Pixels whose label or
    prediction is outside [0, num_classes) (the 255 ignore id, padding)
    contribute nothing, as in the JAX package's `fast_hist_jax`.
    """
    label = label.reshape(-1).long()
    pred = pred.reshape(-1).long()
    k = ((label >= 0) & (label < num_classes)
         & (pred >= 0) & (pred < num_classes))
    return torch.bincount(
        num_classes * label[k] + pred[k], minlength=num_classes ** 2
    ).reshape(num_classes, num_classes)


def per_class_iu(hist: np.ndarray) -> np.ndarray:
    """Per-class IoU = diag / (row + col - diag); NaN for absent classes."""
    hist = np.asarray(hist, dtype=np.float64)
    denom = hist.sum(1) + hist.sum(0) - np.diag(hist)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / denom


def mean_iou(hist: np.ndarray) -> float:
    """nanmean of per-class IoU, in percent."""
    return float(np.nanmean(per_class_iu(hist)) * 100.0)


def label_mapping(arr: np.ndarray, mapping: np.ndarray) -> np.ndarray:
    """Remap raw label ids through an (n, 2) [from, to] table; each row's
    mask is taken against the ORIGINAL array, so remaps do not cascade."""
    out = np.copy(arr)
    for src, dst in np.asarray(mapping):
        out[arr == src] = dst
    return out.astype(np.int64)
