"""The plain float32 evaluation: DeepLab-v2's main head, the logits upsampled
(bilinear, align corners) to the label size, the class of the largest
logit per pixel, and the confusion matrix of labels against classes over
the pixels whose label is a class (AdaptSegNet's evaluate_cityscapes.py
and compute_iou.py).
"""

from __future__ import annotations

import torch

from benchmark.reference import models


@torch.no_grad()
def upsampled_logits(g: models.DeeplabMulti, images: torch.Tensor,
                     out_hw, block: int = 4):
    """Yields (index, (C, H, W) float32 upsampled logits) image by image,
    the forward run in blocks of `block` images."""
    for start in range(0, images.shape[0], block):
        logits = g.main_head(images[start:start + block])
        for i in range(logits.shape[0]):
            yield start + i, models.upsample(logits[i:i + 1], out_hw)[0]


def mask_gap(up: torch.Tensor, mask: torch.Tensor) -> float:
    """The widest gap, over the pixels, by which the logit of the class in
    `mask` lies below the largest logit, as a share of the image's largest
    logit magnitude."""
    chosen = up.gather(0, mask.long().unsqueeze(0))[0]
    return ((up.amax(0) - chosen).amax() / up.abs().amax()).item()


def confusion(labels: torch.Tensor, masks: torch.Tensor,
              classes: int) -> torch.Tensor:
    """Rows the label, columns the class, over pixels whose label and class
    lie in [0, classes)."""
    lab, pred = labels.reshape(-1).long(), masks.reshape(-1).long()
    keep = (lab >= 0) & (lab < classes) & (pred >= 0) & (pred < classes)
    return torch.bincount(classes * lab[keep] + pred[keep],
                          minlength=classes * classes).view(classes, classes)
