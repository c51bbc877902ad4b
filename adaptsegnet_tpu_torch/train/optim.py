"""Optimizers with the reference's update rules and parameter groups.

Counterpart of adaptsegnet_tpu/train/optim.py:
  * generator (reference train_gta2cityscapes_multi.py:244-245,
    model/deeplab_multi.py:196-235): torch.optim.SGD, momentum 0.9, coupled
    weight decay 5e-4 (d = grad + wd * p; buf = m * buf + d; p -= lr * buf,
    the optax chain of `make_generator_tx`), over two groups: the backbone
    at 1x lr and the ASPP heads (`layer5`, `layer6`) at 10x. The frozen BN
    parameters do not require grad and are in no group.
  * discriminators (reference :351, :536-539): torch.optim.Adam(betas=(0.9,
    0.99), eps=1e-8), the bias-corrected rule of optax.scale_by_adam.
Both take the poly LR of train/schedule.py at the step count, set before
each update (`set_poly_lr`).

Not ported yet: `--optim-dup-quirk` (the reference's k-fold duplicated
backbone updates, JAX `_kfold_trace`); train/config.py raises on it.
"""

from __future__ import annotations

import torch
from torch import nn

from adaptsegnet_tpu_torch.train.schedule import lr_poly

HEAD_NAMES = ("layer5", "layer6", "classifier")


def generator_param_groups(model: nn.Module) -> list[dict]:
    """[{'params': backbone, 'lr_mult': 1}, {'params': heads, 'lr_mult': 10}],
    trainable parameters only (the frozen BN is excluded), empty groups
    dropped."""
    backbone, heads = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (heads if name.split(".")[0] in HEAD_NAMES else backbone).append(p)
    groups = [{"params": backbone, "lr_mult": 1.0},
              {"params": heads, "lr_mult": 10.0}]
    return [g for g in groups if g["params"]]


def make_generator_optimizer(model: nn.Module, base_lr: float = 2.5e-4,
                             momentum: float = 0.9,
                             weight_decay: float = 5e-4) -> torch.optim.SGD:
    return torch.optim.SGD(generator_param_groups(model), lr=base_lr,
                           momentum=momentum, weight_decay=weight_decay)


def make_discriminator_optimizer(d: nn.Module, base_lr: float = 1e-4,
                                 b1: float = 0.9,
                                 b2: float = 0.99) -> torch.optim.Adam:
    return torch.optim.Adam(d.parameters(), lr=base_lr, betas=(b1, b2),
                            eps=1e-8)


def set_poly_lr(opt: torch.optim.Optimizer, base_lr: float, step: int,
                num_steps: int, power: float = 0.9) -> float:
    """Set every group's lr to lr_poly(step) times its `lr_mult`; returns
    the base group's lr."""
    lr = lr_poly(base_lr, step, num_steps, power)
    for group in opt.param_groups:
        group["lr"] = lr * group.get("lr_mult", 1.0)
    return lr
