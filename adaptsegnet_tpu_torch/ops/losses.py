"""Segmentation and adversarial objectives.

Counterpart of adaptsegnet_tpu/ops/losses.py (`cross_entropy_2d` :21,
`cross_entropy_2d_planar` :49, `bce_with_logits` :77, `ls_gan_mse` :88,
`gan_loss` :98). NHWC logits (planar for the `_planar` CE), f32 scalar
means:
  * seg loss: torch.nn.CrossEntropyLoss(ignore_index=255) over valid pixels,
    except that a batch with every pixel ignored gives 0 (torch gives NaN),
    as the JAX package does;
  * GAN loss by --gan: 'Vanilla' -> BCE with logits, 'LS' -> MSE on the raw
    discriminator scores; labels source 0, target 1.

In a data-parallel group (parallel/group.py) of W ranks each loss is the
rank's share of the loss over the global batch, so that the shares sum
over the ranks, and the gradients with them, to the single-process loss on
all B images (as GSPMD makes the JAX package's batch means global): the
cross-entropy is the rank's NLL sum over the global count of valid pixels
(all-reduced, clamped at 1 globally), and a mean over equal per-rank
element counts is the rank's mean / W. With no group they are the plain
means.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from adaptsegnet_tpu_torch.parallel import group


def _valid_count(valid: torch.Tensor) -> torch.Tensor:
    """The number of valid pixels over the group, at least 1."""
    return group.all_reduce_sum(valid.sum().float()).clamp(min=1.0)


def _share(mean: torch.Tensor) -> torch.Tensor:
    """A rank's share of a mean over equal per-rank counts."""
    w = group.world()
    return mean / w if w > 1 else mean


def cross_entropy_2d(logits: torch.Tensor, labels: torch.Tensor,
                     ignore_label: int = 255) -> torch.Tensor:
    """logits (N, H, W, C), labels (N, H, W) int -> mean NLL over the
    pixels whose label is not `ignore_label` (0 when there are none); in a
    group, the rank's share of the global mean."""
    logits = logits.float()
    labels = labels.long()
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    nll = (logz - picked) * valid.float()
    return nll.sum() / _valid_count(valid)


def cross_entropy_2d_planar(logits: torch.Tensor, labels: torch.Tensor,
                            ignore_label: int = 255) -> torch.Tensor:
    """cross_entropy_2d on planar (N, C, H, W) logits, as kernel 6 emits
    them: the same mean NLL, reduced over the class axis 1."""
    logits = logits.float()
    labels = labels.long()
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=1)
    picked = logits.gather(1, safe.unsqueeze(1)).squeeze(1)
    nll = (logz - picked) * valid.float()
    return nll.sum() / _valid_count(valid)


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross-entropy on raw logits (torch BCEWithLogitsLoss)."""
    x = logits.float()
    return _share(F.binary_cross_entropy_with_logits(x, torch.full_like(x, target)))


def ls_gan_mse(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean squared error on raw scores (torch MSELoss): --gan LS."""
    x = logits.float()
    return _share(torch.mean(torch.square(x - target)))


def gan_loss(mode: str):
    """The adversarial criterion for --gan 'Vanilla' | 'LS'."""
    if mode == "Vanilla":
        return bce_with_logits
    if mode == "LS":
        return ls_gan_mse
    raise NotImplementedError(f"gan mode {mode!r} is not implemented")
