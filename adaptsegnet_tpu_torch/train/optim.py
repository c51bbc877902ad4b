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

`--optim-dup-quirk` (`dup_quirk=True`) mirrors the reference's literal
dynamics: its 1x group lists every backbone parameter once per ancestor
module (`generator_param_multiplicity`), and torch 0.4's SGD loop then runs
momentum and update k times per step for a k-fold parameter. `KFoldSGD`
applies that in closed form (JAX `_kfold_trace`, train/optim.py:58-131).
DeeplabVGG's optimizer takes plain `.parameters()`: every parameter at 1x
and once (`all_1x=True`).
"""

from __future__ import annotations

import torch
from torch import nn

from adaptsegnet_tpu_torch.train.schedule import lr_poly

HEAD_NAMES = ("layer5", "layer6", "classifier")


def generator_param_multiplicity(model: nn.Module,
                                 all_1x: bool = False) -> dict[str, int]:
    """{parameter name: occurrences in the reference's SGD parameter list},
    trainable parameters only.

    The reference's get_1x_lr_params_NOscale walks `.modules()` and then
    `.parameters()` of each, both recursive (model/deeplab_multi.py:212-217),
    so a backbone parameter is listed once per ancestor module: the stem
    conv1 once, a bottleneck conv 3 times (layer, Bottleneck, conv), a
    downsample conv 4 times (+ the downsample Sequential); on ResNet-101
    the histogram is {1: 1, 3: 99, 4: 4}. The heads, and every parameter of
    the VGG path (`all_1x`), occur once (JAX train/optim.py:58-87)."""
    mults = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        parts = name.split(".")
        if all_1x or not parts[0].startswith("layer") or parts[0] in HEAD_NAMES:
            mults[name] = 1
        else:
            mults[name] = 4 if "downsample" in parts else 3
    return mults


def generator_param_groups(model: nn.Module, all_1x: bool = False,
                           dup_quirk: bool = False) -> list[dict]:
    """[{'params': backbone, 'lr_mult': 1}, {'params': heads, 'lr_mult': 10}],
    trainable parameters only (the frozen BN is excluded), empty groups
    dropped. `all_1x` puts every parameter at 1x (DeeplabVGG); `dup_quirk`
    splits the groups by `generator_param_multiplicity`, one group per
    (lr_mult, k) with its count under 'k'."""
    mults = (generator_param_multiplicity(model, all_1x) if dup_quirk else {})
    groups: dict[tuple[float, int], list] = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            head = not all_1x and name.split(".")[0] in HEAD_NAMES
            groups.setdefault((10.0 if head else 1.0, mults.get(name, 1)),
                              []).append(p)
    return [{"params": params, "lr_mult": lr_mult, "k": k}
            for (lr_mult, k), params in sorted(groups.items())]


class KFoldSGD(torch.optim.Optimizer):
    """SGD with momentum and coupled weight decay in which a group's update
    runs `k` times per step, as torch 0.4's loop did for a parameter listed
    k times: k repetitions of {buf = m * buf + d; p -= lr * buf} with the
    same d = grad + wd * p. In closed form, with S_k = (1 - m^k) / (1 - m)
    and T_k = (k - m * S_k) / (1 - m):

        p   -= lr * (m * S_k * buf + T_k * d)
        buf  = m^k * buf + S_k * d

    (k = 1 is torch.optim.SGD). The weight decay enters d once, before the
    repetitions, as in the JAX chain (`_kfold_trace`'s note: recomputing it
    per repetition differs by O(wd * lr), ~1e-7 relative per step)."""

    def __init__(self, params, lr: float, momentum: float, weight_decay: float):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay, k=1))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            m, k, lr = group["momentum"], group["k"], group["lr"]
            s_k = (1.0 - m ** k) / (1.0 - m)
            t_k = (k - m * s_k) / (1.0 - m)
            for p in group["params"]:
                if p.grad is None:
                    continue
                d = p.grad.add(p, alpha=group["weight_decay"])
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                buf = state["momentum_buffer"]
                p.add_(buf, alpha=-lr * m * s_k).add_(d, alpha=-lr * t_k)
                buf.mul_(m ** k).add_(d, alpha=s_k)


def make_generator_optimizer(model: nn.Module, base_lr: float = 2.5e-4,
                             momentum: float = 0.9,
                             weight_decay: float = 5e-4,
                             all_1x: bool = False,
                             dup_quirk: bool = False) -> torch.optim.Optimizer:
    """torch.optim.SGD over the generator's groups; `KFoldSGD` with the
    reference's duplicate counts under `dup_quirk`."""
    groups = generator_param_groups(model, all_1x, dup_quirk)
    cls = KFoldSGD if dup_quirk else torch.optim.SGD
    return cls(groups, lr=base_lr, momentum=momentum,
               weight_decay=weight_decay)


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
