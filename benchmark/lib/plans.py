"""What one step or one eval call of a DeepLab-v2 path costs, from the
configuration's shapes: the model's operations (for MFU), and the
launches of each hand-written kernel with the work of each (for the
launch check and the rooflines).

A plan is {'model_ops': operations the model requires per call, on all
cards; 'launches': {wrapper: launches per call on one card}; 'items':
[(wrapper, launch)] per call on one card, each launch a dict that the
wrapper's family (work/families) turns into operations and bytes}.

The model's operations are the convolutions' only (two per multiply-add),
the forward passes and the backward passes the step needs, nothing
recomputed: a weight gradient for every trainable convolution that the
loss reaches, an input gradient wherever one is needed to reach another
weight or the generator. Interpolation, softmax, normalisation, losses and
optimizer updates are left out.

Which convolutions run a hand-written kernel mirrors the program's gates
(ops/kernels/*.py `supported*`): kernel 2 on the 3x3s at dilation 2 or 4
with channels in multiples of 128 (train), kernel 3 on the 3x3s at
dilation 1, 2 or 4 with channels in multiples of 128 on a bf16 batch of
an even number of images (eval), kernel 5 on the 4x4/2s with 2 Cin and
Cout multiples of 128, kernel 4 on the discriminator's conv1.
"""

from __future__ import annotations

from benchmark.lib import deeplab
from benchmark.lib.deeplab import conv_ops


def _is_k2(c: dict, batched: bool) -> bool:
    dils = (1, 2, 4) if batched else (2, 4)
    return (c["k"] == 3 and c["stride"] == 1 and c["dil"] in dils
            and c["cin"] % 128 == 0 and c["cout"] % 128 == 0)


def _is_k5(c: dict) -> bool:
    return (c["k"] == 4 and c["stride"] == 2 and (2 * c["cin"]) % 128 == 0
            and c["cout"] % 128 == 0 and c["h"] % 2 == 0 and c["w"] % 2 == 0)


class _Plan:
    def __init__(self):
        self.model_ops, self.launches, self.items = 0, {}, []

    def add(self, wrapper: str, n: int, reps: int = 1, **launch):
        self.launches[wrapper] = self.launches.get(wrapper, 0) + reps
        self.items += [(wrapper, dict(wrapper=wrapper, n=n, **launch))] * reps

    def done(self) -> dict:
        return {"model_ops": self.model_ops, "launches": self.launches,
                "items": self.items}


def train_multilevel(cfg: dict, n: int, cards: int = 1) -> dict:
    """One multi-level adversarial step on n source and n target images
    per card: G forward on both domains and its backward; each D applied
    once in G's loss (forward and input gradients) and twice in its own
    (forward, weight gradients, input gradients past conv1)."""
    hw = cfg["input_size"]
    g = (deeplab.backbone(cfg, hw) + deeplab.aspp(cfg, hw, 3, "layer5")
         + deeplab.aspp(cfg, hw, 4, "layer6"))
    d = deeplab.discriminator(cfg, hw)
    total = 2 * n * cards
    p = _Plan()
    g_fwd = sum(conv_ops(c, total) for c in g)
    p.model_ops += 3 * g_fwd - conv_ops(g[0], total)
    d_fwd = sum(conv_ops(c, n * cards) for c in d)
    d_conv1 = conv_ops(d[0], n * cards)
    per_d = 3 * d_fwd + d_fwd + 2 * (d_fwd + d_fwd - d_conv1)
    p.model_ops += 2 * per_d
    for c in g:
        if _is_k2(c, batched=False):
            p.add("conv3x3_dil_fwd", n, 2, conv=c)
            p.add("conv3x3_dil_dgrad", n, 2, conv=c)
    for c in d:
        if _is_k5(c):
            p.add("conv4x4_s2_fwd", n, 6, conv=c)
            p.add("conv4x4_s2_dgrad", n, 6, conv=c)
            p.add("conv4x4_s2_wgrad", n, 4, conv=c)
    p.add("conv4x4_patch_fwd", n, 6, conv=d[0])
    p.add("conv4x4_patch_dgrad", n, 2, conv=d[0])
    p.add("conv4x4_patch_wgrad", n, 4, conv=d[0])
    return p.done()


def train_source_only_warper(cfg: dict, n: int, cards: int = 1) -> dict:
    """One source-only step with the Warper on n images per card: the
    Warper's forward without gradient, G's forward through the main head
    (the auxiliary head runs, but the loss needs nothing of it) and its
    backward, kernel 6's forward and input gradient."""
    hw = cfg["input_size"]
    g = deeplab.backbone(cfg, hw) + deeplab.aspp(cfg, hw, 4, "layer6")
    w = deeplab.warper(cfg, hw)
    total = n * cards
    p = _Plan()
    p.model_ops += (3 * sum(conv_ops(c, total) for c in g)
                    - conv_ops(g[0], total)
                    + sum(conv_ops(c, total) for c in w))
    for c in g:
        if _is_k2(c, batched=False):
            p.add("conv3x3_dil_fwd", n, conv=c)
            p.add("conv3x3_dil_dgrad", n, conv=c)
    for c in w:
        if _is_k5(c):
            p.add("conv4x4_s2_fwd", n, conv=c)
    h, wd, _ = deeplab.feature_hw(cfg, hw, 4)
    launch = dict(h=h, w=wd, c=cfg["num_classes"], oh=hw[0], ow=hw[1], es=2)
    p.add("upsample_warp_fwd", n, **launch)
    p.add("upsample_warp_dx", n, **launch)
    return p.done()


def eval_batch(cfg: dict, n: int, cards: int = 1) -> dict:
    """One bf16 eval call on n images per card: the forward through the
    main head, kernel 1's upsample and argmax to the label size."""
    hw = cfg["input_size"]
    g = deeplab.backbone(cfg, hw) + deeplab.aspp(cfg, hw, 4, "layer6")
    p = _Plan()
    p.model_ops += sum(conv_ops(c, n * cards) for c in g)
    if n >= 2 and n % 2 == 0:
        for c in g:
            if _is_k2(c, batched=True):
                p.add("conv3x3_dil_batched_fwd", n, conv=c)
    h, wd, _ = deeplab.feature_hw(cfg, hw, 4)
    oh, ow = cfg["eval_output_size"]
    p.add("upsample_argmax", n, h=h, w=wd, c=cfg["num_classes"], oh=oh, ow=ow,
          es=2)
    return p.done()
