"""Construct the models and the train state from a TrainConfig.

Counterpart of adaptsegnet_tpu/train/build.py (`build_train_state`
:134-210): DeeplabMulti (in either `--bn-mode`) or, for `--model
DeeplabVGG`, the VGG segmenter behind the (pred1, pred2) contract
(`_VGGAsMulti`, :42-58), in the compute dtype, the reference's restore-from
surgery (reference train_gta2cityscapes_multi.py:202-215: `Scale.` /
`module.` prefixes stripped, layer5 skipped when num_classes == 19, both
heads with --not-restore-last), D1/D2 for the adversarial modes, and their
optimizers, and the Warper when the mode uses it (source-only and
single-level with --warper; `:187-201`) in the compute dtype, with planar
flow and no optimizer. Weights are drawn from torch generators seeded with
--random-seed (G), --random-seed + 1 / + 2 (D1 / D2) and + 3 (Warper).
"""

from __future__ import annotations

import os.path as osp
import sys

import torch

from adaptsegnet_tpu_torch.models import (
    DeeplabMulti,
    DeeplabVGG,
    FCDiscriminator,
    Warper,
)
from adaptsegnet_tpu_torch.train.config import TrainConfig, check_supported
from adaptsegnet_tpu_torch.train.optim import (
    make_discriminator_optimizer,
    make_generator_optimizer,
)
from adaptsegnet_tpu_torch.train.state import Schedule, TrainState
from adaptsegnet_tpu_torch.utils import pth_interop


def _dtype_of(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class _VGGAsMulti(DeeplabVGG):
    """DeeplabVGG behind the (pred1, pred2) contract of the train steps: the
    aux output aliases the main one. Single-level training, the only mode
    the paper uses for VGG, never reads the aux output. The state-dict keys
    stay DeeplabVGG's (the reference's)."""

    def forward(self, x_nhwc: torch.Tensor):
        out = super().forward(x_nhwc)
        return out, out


def build_generator(cfg: TrainConfig, generator: torch.Generator):
    """The segmenter on the CPU with fresh weights. The VGG-16 backbone has
    no BN, so --bn-mode does nothing there."""
    dtype = _dtype_of(cfg)
    if cfg.model == "DeepLab":
        return DeeplabMulti(num_classes=cfg.num_classes, dtype=dtype,
                            device="cpu", generator=generator,
                            bn_mode=cfg.bn_mode)
    if cfg.model == "DeeplabVGG":
        return _VGGAsMulti(num_classes=cfg.num_classes, dtype=dtype,
                           device="cpu", generator=generator)
    raise NotImplementedError(f"model {cfg.model!r}")


def restore_generator(cfg: TrainConfig, model: torch.nn.Module) -> bool:
    """Load --restore-from over the fresh weights; False when it is ''. The
    layer5 / --not-restore-last surgery applies to the ResNet checkpoints;
    a VGG checkpoint (`features.*`, `classifier.*`) loads whole (JAX
    :111-116)."""
    if not cfg.restore_from:
        return False
    if not osp.exists(cfg.restore_from):
        raise FileNotFoundError(
            "--restore-from checkpoint not found: "
            f"{osp.abspath(cfg.restore_from)!r} (pass --restore-from '' to "
            "train from random init)")
    sd = pth_interop.load_torch_state_dict(cfg.restore_from)
    skip = set()
    if cfg.model == "DeepLab":
        if cfg.num_classes == 19:
            skip.add("layer5")
        if cfg.not_restore_last:
            skip.update(("layer5", "layer6"))
    sd = {k: v for k, v in sd.items() if k.split(".")[0] not in skip}
    pth_interop.load_into(model, sd)
    print(f"restored {len(sd)}/{len(model.state_dict())} tensors from "
          f"{cfg.restore_from}", file=sys.stderr)
    return True


def build_train_state(cfg: TrainConfig, device: torch.device) -> TrainState:
    check_supported(cfg)
    dtype = _dtype_of(cfg)
    seed = cfg.random_seed
    model = build_generator(cfg, torch.Generator().manual_seed(seed))
    restore_generator(cfg, model)
    model.to(device)
    state = TrainState(
        model=model,
        g_opt=make_generator_optimizer(
            model, cfg.learning_rate, cfg.momentum, cfg.weight_decay,
            all_1x=cfg.model == "DeeplabVGG", dup_quirk=cfg.optim_dup_quirk),
        schedule=Schedule(cfg.learning_rate, cfg.learning_rate_D,
                          cfg.num_steps, cfg.power),
    )
    if not cfg.source_only:
        def disc(offset):
            d = FCDiscriminator(
                num_classes=cfg.num_classes, dtype=dtype, device=device,
                generator=torch.Generator().manual_seed(seed + offset))
            return d, make_discriminator_optimizer(d, cfg.learning_rate_D)

        state.d2, state.d2_opt = disc(2)
        if cfg.level == "multi-level":
            state.d1, state.d1_opt = disc(1)
    if cfg.uses_warper:
        state.warper = Warper(
            num_layers=cfg.warper_num_layers, norm=cfg.warper_norm,
            dtype=dtype, device=device,
            generator=torch.Generator().manual_seed(seed + 3))
        state.warper.check_size(cfg.input_hw)
    return state
