"""The plain float32 train steps of AdaptSegNet and of the fork's default.

* Multi-level (AdaptSegNet, arXiv:1802.10349, section 3 and 4): the
  segmentation loss on the source, cross-entropy of both heads' logits
  upsampled (align corners) to the input, ignoring label 255, weighted 1
  (main) and lambda_seg (auxiliary); the adversarial loss on the target,
  LS-GAN (mean squared error of D's raw scores against the source label
  0) of each head's softmax map, weighted lambda_adv1 / lambda_adv2, with
  the discriminators held fixed; then each discriminator's loss on the
  detached maps, source against 0 and target against 1, each half. Every
  gradient is taken at the parameters before the step; G then takes an
  SGD step (momentum, coupled weight decay, the heads at ten times the
  rate), each D an Adam step, at the poly rate of the step count. A G
  parameter that the loss does not reach still takes its decay and
  momentum.
* Source-only with the Warper (the sahngmin/AdaptSegNet fork): the Warper
  runs in train mode without gradient on the batch (its BatchNorm
  statistics move), the main head's upsampled logits are warped by its
  flow, and the cross-entropy of the warped logits trains G alone.

The batch is processed in blocks of `block` images so that float32 fits
the card: each loss is the block's sum over the whole batch's count, and
the gradients of the blocks add up. The Warper runs on the whole batch at
once, since its batch statistics are the batch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import models
from benchmark.reference.numerics import Numerics

SOURCE, TARGET = 0.0, 1.0
HEADS = ("layer5", "layer6")
METRICS = ("loss_seg1", "loss_seg2", "loss_adv_target1", "loss_adv_target2",
           "loss_D1", "loss_D2")


def poly_lr(base: float, step: int, num_steps: int, power: float) -> float:
    return base * max(1.0 - step / num_steps, 0.0) ** power


def nll_sum(logits: torch.Tensor, labels: torch.Tensor, ignore: int):
    """Summed cross-entropy of NCHW logits over the labels that are not
    `ignore`."""
    return F.cross_entropy(logits, labels.long(), ignore_index=ignore,
                           reduction="sum")


class ReferenceTrainer:
    """The reference's models, optimizers and step for one configuration,
    from `weights` ({'G', 'D1', 'D2', 'W'}: state dicts, as the benchmark
    made them)."""

    def __init__(self, cfg: dict, weights: dict, device, num: Numerics,
                 block: int = 4):
        self.cfg, self.block, self.step_count = cfg, block, 0
        self.multi = cfg["mode"] == "multi-level"
        self.g = models.DeeplabMulti(cfg, num, device)
        self.g.load_state_dict(weights["G"])
        backbone = [p for n, p in self.g.named_parameters()
                    if p.requires_grad and n.split(".")[0] not in HEADS]
        heads = [p for n, p in self.g.named_parameters()
                 if n.split(".")[0] in HEADS]
        self.g_opt = torch.optim.SGD(
            [{"params": backbone, "lr_mult": 1.0},
             {"params": heads, "lr_mult": 10.0}],
            lr=cfg["learning_rate"], momentum=cfg["momentum"],
            weight_decay=cfg["weight_decay"])
        self.ds, self.d_opts = [], []
        self.warper = None
        if self.multi:
            for key in ("D1", "D2"):
                d = models.FCDiscriminator(cfg, num, device)
                d.load_state_dict(weights[key])
                self.ds.append(d)
                self.d_opts.append(torch.optim.Adam(
                    d.parameters(), lr=cfg["learning_rate_D"],
                    betas=tuple(cfg["adam_betas"]), eps=1e-8))
        else:
            self.warper = models.Warper(cfg, num, device)
            self.warper.load_state_dict(weights["W"])

    def modules(self) -> dict:
        out = {"G": self.g}
        if self.multi:
            out["D1"], out["D2"] = self.ds
        return out

    def _set_lrs(self):
        c, k = self.cfg, self.step_count
        lr = poly_lr(c["learning_rate"], k, c["num_steps"], c["power"])
        for group in self.g_opt.param_groups:
            group["lr"] = lr * group["lr_mult"]
        for opt in self.d_opts:
            for group in opt.param_groups:
                group["lr"] = poly_lr(c["learning_rate_D"], k, c["num_steps"],
                                      c["power"])

    def step(self, batch: dict, d1_split: bool = False) -> dict:
        """One step on `batch` ({'images', 'labels'[, 'target_images']},
        on the device); the losses, as floats. With `d1_split`, D1's loss
        sums over the first half of the batch alone, still over the whole
        batch's count (a planted fault: a D1 weight gradient that drops
        half of its sum, as a lost split would)."""
        self._set_lrs()
        for opt in (self.g_opt, *self.d_opts):
            opt.zero_grad(set_to_none=True)
        sums = {k: 0.0 for k in METRICS}
        if self.multi:
            self._adversarial(batch, sums, d1_split)
        else:
            self._source_only(batch, sums)
        for p in self.g.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        for opt in (self.g_opt, *self.d_opts):
            opt.step()
        self.step_count += 1
        return sums if self.multi else {"loss_seg2": sums["loss_seg2"]}

    def _blocks(self, n: int):
        return [slice(i, min(i + self.block, n))
                for i in range(0, n, self.block)]

    def _source_only(self, batch, sums):
        images, labels = batch["images"], batch["labels"]
        ignore = self.cfg["ignore_label"]
        valid = (labels != ignore).sum().clamp(min=1).float()
        with torch.no_grad():
            flow = self.warper(images)
        for sl in self._blocks(images.shape[0]):
            _, pred2 = self.g(images[sl])
            loss = nll_sum(models.upsample_warp(pred2, flow[sl]), labels[sl],
                           ignore) / valid
            loss.backward()
            sums["loss_seg2"] += loss.item()

    def _adversarial(self, batch, sums, d1_split):
        c = self.cfg
        images, labels = batch["images"], batch["labels"]
        target = batch["target_images"]
        hw = images.shape[1:3]
        ignore = c["ignore_label"]
        valid = (labels != ignore).sum().clamp(min=1).float()
        n_total = images.shape[0]
        d1, d2 = self.ds
        d_count = None

        def mse_sum(scores, label):
            return torch.square(scores - label).sum()

        for sl in self._blocks(images.shape[0]):
            for d in self.ds:
                d.requires_grad_(False)
            pred1_s, pred2_s = self.g(images[sl])
            pred1_t, pred2_t = self.g(target[sl])
            up2_s = models.upsample(pred2_s, hw)
            up1_s = models.upsample(pred1_s, hw)
            sm2_t = torch.softmax(models.upsample(pred2_t, hw), 1)
            sm1_t = torch.softmax(models.upsample(pred1_t, hw), 1)
            score2, score1 = d2(sm2_t), d1(sm1_t)
            if d_count is None:
                d_count = float(n_total * score2[0].numel())
            loss_seg2 = nll_sum(up2_s, labels[sl], ignore) / valid
            loss_seg1 = nll_sum(up1_s, labels[sl], ignore) / valid
            adv2 = mse_sum(score2, SOURCE) / d_count
            adv1 = mse_sum(score1, SOURCE) / d_count
            total = (loss_seg2 + c["lambda_adv_target2"] * adv2
                     + c["lambda_seg"] * loss_seg1
                     + c["lambda_adv_target1"] * adv1)
            total.backward()
            for d in self.ds:
                d.requires_grad_(True)
            sm2_s = torch.softmax(up2_s.detach(), 1)
            sm1_s = torch.softmax(up1_s.detach(), 1)
            loss_d2 = (mse_sum(d2(sm2_s), SOURCE)
                       + mse_sum(d2(sm2_t.detach()), TARGET)) / d_count / 2
            rows = (slice(0, max(0, n_total // 2 - sl.start)) if d1_split
                    else slice(None))
            loss_d1 = (mse_sum(d1(sm1_s[rows]), SOURCE)
                       + mse_sum(d1(sm1_t.detach()[rows]), TARGET)) / d_count / 2
            (loss_d2 + loss_d1).backward()
            for k, v in (("loss_seg1", loss_seg1), ("loss_seg2", loss_seg2),
                         ("loss_adv_target1", adv1),
                         ("loss_adv_target2", adv2),
                         ("loss_D1", loss_d1), ("loss_D2", loss_d2)):
                sums[k] += v.item()
