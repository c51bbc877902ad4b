"""Train steps: source-only and adversarial (single- and multi-level), eager.

Counterpart of adaptsegnet_tpu/train/steps.py (`make_source_only_step`
:117-201, `make_adversarial_step` :204-443), keeping its
choreography (reference train_gta2cityscapes_multi.py:385-464, :578-683):
  * generator loss = CE(pred2_s) + lambda_seg * CE(pred1_s)
    + lambda_adv1 * GAN(D1(sm1_t), source) + lambda_adv2 * GAN(D2(sm2_t),
    source); its backward reaches G only: the D parameters do not require
    grad while it runs (the reference's requires_grad=False);
  * discriminator losses on the detached maps, each domain / 2, labels
    source = 0 and target = 1;
  * iter-size accumulation as the mean over micro-batches (losses scaled by
    1 / iter_size before each backward);
  * every gradient is taken at the pre-update parameters; then the three
    optimizers step, at the poly LR of the step count.
The discriminator input is the planar softmax map of the upsampled raw
logits (ops/resize.py::upsample_softmax_planar). bf16 models upsample the
segmentation logits in bf16 (exact=False), f32 models exactly.

With a Warper in the state (source-only and single-level; the fork's
default mode is source-only with it), each micro-batch first runs the
Warper on the source images, in train mode under `torch.no_grad()`: its BN
running statistics move, its weights never do, and the flow is a constant
of the loss (so the warp's d-flow kernel never runs). The main head's
upsample is then the fused upsample + warp (ops/upsample_warp.py, kernel
6) emitting planar logits for the planar CE; in single-level the source
flow also warps the target prediction (the fork's quirk, `:270-277`), and
the discriminator reads softmax(dim=1) of the warped planar maps.

A generator in `bn_mode='batch'` (--bn-mode batch) normalises by batch
statistics and moves its BN running statistics in place on every forward,
source then target, the reference's order (JAX :280-290 carries
`batch_stats` through the same two forwards); they are buffers of the
model, so the snapshots and the full-state resume hold them.

A step takes `batch = {'images': (iter_size, B, H, W, 3), 'labels':
(iter_size, B, H, W), 'target_images': (iter_size, B, H, W, 3)}` on the
model's device, updates the state in place and returns the metrics under
the reference's names as 0-d f32 tensors (no host sync).

In a data-parallel group (parallel/group.py) the batch is the rank's part
of the global batch and the step computes what one process computes on
the whole of it, as GSPMD makes the JAX step under a mesh: each loss is the
rank's share of the global one (ops/losses.py), the batch statistics are
global (models/layers.py), and after every micro-batch's backward, before
the optimizers step, each module's gradients are summed over the group in
one collective (`group.all_reduce_grads`; no DistributedDataParallel, whose
hooks do not take the D's requires_grad toggling). The metrics are the
rank's shares, summed over the group in one all-reduce with `extra`
(further per-rank 0-d values, the loop's stop vote), so every rank returns
the global values; the all-reduce is enqueued like the step's kernels.
"""

from __future__ import annotations

import torch
from torch import nn

from adaptsegnet_tpu_torch.ops.losses import (
    cross_entropy_2d,
    cross_entropy_2d_planar,
    gan_loss,
)
from adaptsegnet_tpu_torch.ops.resize import (
    upsample_logits,
    upsample_softmax_planar,
)
from adaptsegnet_tpu_torch.ops.upsample_warp import upsample_warp
from adaptsegnet_tpu_torch.parallel import group
from adaptsegnet_tpu_torch.train.state import TrainState

SOURCE_LABEL = 0.0  # reference :363
TARGET_LABEL = 1.0  # reference :364
METRIC_NAMES = ("loss_seg1", "loss_seg2", "loss_adv_target1",
                "loss_adv_target2", "loss_D1", "loss_D2")


def _exact(model: nn.Module) -> bool:
    return getattr(model, "dtype", torch.float32) == torch.float32


def _set_requires_grad(modules, flag: bool) -> None:
    for m in modules:
        if m is not None:
            for p in m.parameters():
                p.requires_grad_(flag)


def _zero_grads(state: TrainState) -> None:
    for opt in (state.g_opt, state.d1_opt, state.d2_opt):
        if opt is not None:
            opt.zero_grad(set_to_none=True)


def _reduce(metrics: dict, extra: dict | None) -> dict:
    """The step's metrics (and `extra`) summed over the group in one
    all-reduce; unchanged (with `extra` added) with no group."""
    metrics = {**metrics, **(extra or {})}
    if not group.active():
        return metrics
    names = sorted(metrics)
    total = group.all_reduce_sum(torch.stack(
        [metrics[k].float().reshape(()) for k in names]))
    return dict(zip(names, total.unbind()))


def _apply(state: TrainState) -> None:
    # A parameter the loss did not reach (the aux head outside multi-level)
    # still gets its weight decay and momentum, as under optax, where its
    # gradient is zero rather than absent.
    for group in state.g_opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    for opt in (state.g_opt, state.d1_opt, state.d2_opt):
        if opt is not None:
            opt.step()  # an optimizer whose params got no grad moves nothing
    state.step += 1


def _flow(state: TrainState, images: torch.Tensor):
    """The Warper's flow for `images`, a constant of the loss (train mode:
    the running statistics update); None without a Warper."""
    if state.warper is None:
        return None
    state.warper.train()
    with torch.no_grad():
        return state.warper(images)[0]


def make_source_only_step(input_hw=(512, 1024), iter_size: int = 1):
    """Source-domain CE pretraining step (reference :230-314), with the
    state's Warper when it has one."""

    def step(state: TrainState, batch, extra: dict | None = None) -> dict:
        exact = _exact(state.model)
        state.set_lrs()
        _zero_grads(state)
        total = torch.zeros((), device=batch["images"].device)
        for k in range(iter_size):
            flow = _flow(state, batch["images"][k])
            _, pred2 = state.model(batch["images"][k])
            if flow is None:
                loss = cross_entropy_2d(upsample_logits(pred2, input_hw, exact),
                                        batch["labels"][k])
            else:
                loss = cross_entropy_2d_planar(
                    upsample_warp(pred2, flow, input_hw), batch["labels"][k])
            (loss / iter_size).backward()
            total = total + loss.detach() / iter_size
        group.all_reduce_grads((state.model,))
        _apply(state)
        return _reduce({"loss_seg2": total}, extra)

    return step


def make_adversarial_step(
    level: str = "multi-level",
    gan: str = "LS",
    lambda_seg: float = 0.1,
    lambda_adv1: float = 0.0002,
    lambda_adv2: float = 0.001,
    input_hw=(512, 1024),
    iter_size: int = 1,
):
    """Fused-order G/D adversarial step (reference :316-496, :498-722); the
    state's Warper, if any, is used in single-level only (JAX :270-277)."""
    if level not in ("single-level", "multi-level"):
        raise NotImplementedError(f"level choice {level!r} is not implemented")
    criterion = gan_loss(gan)
    multi = level == "multi-level"

    def step(state: TrainState, batch, extra: dict | None = None) -> dict:
        exact = _exact(state.model)
        d1 = state.d1 if multi else None
        d2 = state.d2
        state.set_lrs()
        _zero_grads(state)
        dev = batch["images"].device
        metrics = {k: torch.zeros((), device=dev) for k in METRIC_NAMES}

        def add(name, value):
            metrics[name] = metrics[name] + value.detach() / iter_size

        for k in range(iter_size):
            flow = None if multi else _flow(state, batch["images"][k])
            # Generator loss; the Ds are constants here.
            _set_requires_grad((d1, d2), False)
            pred1_s, pred2_s = state.model(batch["images"][k])
            labels = batch["labels"][k]
            pred1_t, pred2_t = state.model(batch["target_images"][k])
            if flow is None:
                loss_seg2 = cross_entropy_2d(
                    upsample_logits(pred2_s, input_hw, exact), labels)
                sm2_t = upsample_softmax_planar(pred2_t, input_hw)
                sm2_s = upsample_softmax_planar(pred2_s.detach(), input_hw)
            else:
                # the source flow warps both domains (the fork's quirk)
                warped_s = upsample_warp(pred2_s, flow, input_hw)
                loss_seg2 = cross_entropy_2d_planar(warped_s, labels)
                sm2_t = torch.softmax(upsample_warp(pred2_t, flow, input_hw), 1)
                sm2_s = torch.softmax(warped_s.detach(), 1)
            loss_adv2 = criterion(d2(sm2_t), SOURCE_LABEL)
            total = loss_seg2 + lambda_adv2 * loss_adv2
            if multi:
                loss_seg1 = cross_entropy_2d(
                    upsample_logits(pred1_s, input_hw, exact), labels)
                sm1_t = upsample_softmax_planar(pred1_t, input_hw)
                loss_adv1 = criterion(d1(sm1_t), SOURCE_LABEL)
                total = total + lambda_seg * loss_seg1 + lambda_adv1 * loss_adv1
                add("loss_seg1", loss_seg1)
                add("loss_adv_target1", loss_adv1)
            (total / iter_size).backward()
            add("loss_seg2", loss_seg2)
            add("loss_adv_target2", loss_adv2)
            _set_requires_grad((d1, d2), True)

            # Discriminator losses on detached maps: each domain / 2.
            def d_loss(d, sm_s, sm_t):
                return (criterion(d(sm_s), SOURCE_LABEL) / 2.0
                        + criterion(d(sm_t.detach()), TARGET_LABEL) / 2.0)

            loss_d2 = d_loss(d2, sm2_s, sm2_t)
            d_total = loss_d2
            add("loss_D2", loss_d2)
            if multi:
                loss_d1 = d_loss(
                    d1, upsample_softmax_planar(pred1_s.detach(), input_hw), sm1_t)
                d_total = d_total + loss_d1
                add("loss_D1", loss_d1)
            (d_total / iter_size).backward()
        group.all_reduce_grads((state.model, d1, d2))
        _apply(state)
        return _reduce(metrics, extra)

    return step
