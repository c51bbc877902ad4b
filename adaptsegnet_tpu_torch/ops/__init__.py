"""Numerics of the port: resize, ASPP sum, metrics, precision, CUDA kernels."""

from adaptsegnet_tpu_torch.ops.aspp import aspp_sum
from adaptsegnet_tpu_torch.ops.metrics import fast_hist, mean_iou, per_class_iu
from adaptsegnet_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
    upsample_logits,
)

__all__ = [
    "aspp_sum",
    "fast_hist",
    "mean_iou",
    "per_class_iu",
    "resize_bilinear_align_corners",
    "upsample_logits",
]
