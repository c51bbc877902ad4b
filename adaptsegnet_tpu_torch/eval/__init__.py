"""Evaluation: Cityscapes val inference -> PNGs -> mIoU."""

from adaptsegnet_tpu_torch.eval.compute_iou import compute_mIoU
from adaptsegnet_tpu_torch.eval.evaluator import Evaluator, make_eval_fn
from adaptsegnet_tpu_torch.eval.palette import CITYSCAPES_PALETTE, colorize_mask

__all__ = [
    "CITYSCAPES_PALETTE",
    "colorize_mask",
    "Evaluator",
    "make_eval_fn",
    "compute_mIoU",
]
