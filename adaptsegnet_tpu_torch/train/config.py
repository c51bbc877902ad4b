"""Config dataclass + CLI with the JAX package's flag surface and defaults.

Counterpart of adaptsegnet_tpu/train/config.py (reference
train_gta2cityscapes_multi.py:24-156): the same flags, names, types and
defaults, parsed the same way. `--num-devices` (0 = every visible card)
sets the data-parallel world size through `parallel.auto_world_size`, as
the JAX package sizes its mesh; `check_supported` raises when the global
`--batch-size` does not divide by the group's size. Deviations from the
JAX defaults: none;
`--orbax-checkpoints` keeps its name for flag parity and saves the full
state with torch.save (utils/checkpoint.py).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass

from adaptsegnet_tpu_torch.parallel import group


@dataclass
class TrainConfig:
    # Mode (reference module constants :24-25, exposed as flags).
    source_only: bool = True
    level: str = "single-level"
    model: str = "DeepLab"
    target: str = "cityscapes"

    # Data.
    source: str = "GTA5"
    batch_size: int = 1
    iter_size: int = 1
    num_workers: int = 4
    data_dir: str = "./data/GTA5"
    data_list: str = "./dataset/gta5_list/train.txt"
    data_dir_target: str = "./data/CityScapes"
    data_list_target: str = "./dataset/cityscapes_list/train.txt"
    ignore_label: int = 255
    input_size: str = "1024,512"          # W,H (torch crop_size order)
    input_size_target: str = "1024,512"
    set: str = "train"
    random_mirror: bool = False
    random_scale: bool = False

    # Optimization (:45-66).
    learning_rate: float = 2.5e-4
    momentum: float = 0.9
    weight_decay: float = 0.0005
    learning_rate_D: float = 1e-4
    power: float = 0.9
    num_steps: int = 250_000
    num_steps_stop: int = 150_000
    lambda_seg: float = 0.1
    lambda_adv_target1: float = 0.0002
    lambda_adv_target2: float = 0.001
    gan: str = "LS"

    # Model / restore.
    num_classes: int = 19
    restore_from: str = "DeepLab_resnet_pretrained_init-f81d91e8.pth"
    not_restore_last: bool = False
    warper: bool = True
    warper_norm: str = "Batch"
    warper_num_layers: int = 8

    # Bookkeeping.
    random_seed: int = 1338
    save_pred_every: int = 5000
    snapshot_dir: str = "./snapshots/"
    log_dir: str = "./log"
    tensorboard: bool = False
    save_num_images: int = 2
    cpu: bool = False
    bn_mode: str = "frozen"
    optim_dup_quirk: bool = False

    # Extras of the JAX package (no reference counterpart).
    num_devices: int = 0          # 0 = all local devices
    profile_dir: str = ""         # torch.profiler trace of a few steps
    compute_dtype: str = "float32"  # 'bfloat16' for speed
    orbax_checkpoints: bool = True  # full-state resume beside the .pth files

    @property
    def input_hw(self) -> tuple[int, int]:
        w, h = map(int, self.input_size.split(","))
        return (h, w)

    @property
    def input_hw_target(self) -> tuple[int, int]:
        w, h = map(int, self.input_size_target.split(","))
        return (h, w)

    @property
    def crop_size_wh(self) -> tuple[int, int]:
        w, h = map(int, self.input_size.split(","))
        return (w, h)

    @property
    def crop_size_wh_target(self) -> tuple[int, int]:
        w, h = map(int, self.input_size_target.split(","))
        return (w, h)

    @property
    def uses_warper(self) -> bool:
        """The JAX package builds the Warper only for source-only and
        single-level training (adaptsegnet_tpu/train/build.py:187)."""
        return self.warper and (self.source_only or self.level == "single-level")


def check_supported(cfg: TrainConfig) -> None:
    """Raise ValueError when the global batch does not divide by the
    data-parallel group's size (JAX adaptsegnet_tpu/train/loop.py:63-68)."""
    w = group.world()
    if cfg.batch_size % w:
        raise ValueError(
            f"global batch {cfg.batch_size} not divisible by {w} processes")


def world_size(cfg: TrainConfig) -> int:
    """The number of ranks `--num-devices` asks for: JAX's mesh size for
    the global batch over the visible cards (one CPU with --cpu)."""
    return group.auto_world_size(cfg.batch_size, cfg.num_devices,
                                 group.device_count(cfg.cpu))


def _add_bool_flag(parser, name, default, help_):
    dest = name.replace("-", "_")
    parser.add_argument(
        f"--{name}", dest=dest, action="store_true", default=default, help=help_
    )
    parser.add_argument(f"--no-{name}", dest=dest, action="store_false")


def build_parser() -> argparse.ArgumentParser:
    d = TrainConfig()
    p = argparse.ArgumentParser(description="DeepLab-ResNet Network (CUDA)")
    p.add_argument("--model", type=str, default=d.model,
                   help="available options : DeepLab / DeeplabVGG")
    p.add_argument("--target", type=str, default=d.target)
    p.add_argument("--source", type=str, default=d.source,
                   help="source domain dataset: GTA5 / Synscapes")
    p.add_argument("--batch-size", type=int, default=d.batch_size)
    p.add_argument("--iter-size", type=int, default=d.iter_size)
    p.add_argument("--num-workers", type=int, default=d.num_workers)
    p.add_argument("--data-dir", type=str, default=d.data_dir)
    p.add_argument("--data-list", type=str, default=d.data_list)
    p.add_argument("--ignore-label", type=int, default=d.ignore_label)
    p.add_argument("--input-size", type=str, default=d.input_size)
    p.add_argument("--data-dir-target", type=str, default=d.data_dir_target)
    p.add_argument("--data-list-target", type=str, default=d.data_list_target)
    p.add_argument("--input-size-target", type=str, default=d.input_size_target)
    p.add_argument("--learning-rate", type=float, default=d.learning_rate)
    p.add_argument("--learning-rate-D", type=float, default=d.learning_rate_D)
    p.add_argument("--lambda-seg", type=float, default=d.lambda_seg)
    p.add_argument("--lambda-adv-target1", type=float, default=d.lambda_adv_target1)
    p.add_argument("--lambda-adv-target2", type=float, default=d.lambda_adv_target2)
    p.add_argument("--momentum", type=float, default=d.momentum)
    _add_bool_flag(p, "not-restore-last", d.not_restore_last,
                   "Whether to not restore last (FC) layers.")
    p.add_argument("--num-classes", type=int, default=d.num_classes)
    p.add_argument("--num-steps", type=int, default=d.num_steps)
    p.add_argument("--num-steps-stop", type=int, default=d.num_steps_stop)
    p.add_argument("--power", type=float, default=d.power)
    _add_bool_flag(p, "random-mirror", d.random_mirror,
                   "Randomly mirror the inputs during the training.")
    _add_bool_flag(p, "random-scale", d.random_scale,
                   "Randomly scale the inputs during the training.")
    p.add_argument("--random-seed", type=int, default=d.random_seed)
    p.add_argument("--restore-from", type=str, default=d.restore_from)
    p.add_argument("--save-num-images", type=int, default=d.save_num_images)
    p.add_argument("--save-pred-every", type=int, default=d.save_pred_every)
    p.add_argument("--snapshot-dir", type=str, default=d.snapshot_dir)
    p.add_argument("--weight-decay", type=float, default=d.weight_decay)
    _add_bool_flag(p, "tensorboard", d.tensorboard, "Log scalars to tensorboard.")
    p.add_argument("--log-dir", type=str, default=d.log_dir)
    p.add_argument("--set", type=str, default=d.set)
    p.add_argument("--gan", type=str, default=d.gan,
                   help="choose the GAN objective: LS / Vanilla")
    p.add_argument("--level", type=str, default=d.level,
                   help="single-level/multi-level")
    _add_bool_flag(p, "source-only", d.source_only,
                   "Source-domain CE pretraining only (no adversarial).")
    _add_bool_flag(p, "warper", d.warper, "Enable the flow-field Warper.")
    p.add_argument("--warper-norm", type=str, default=d.warper_norm,
                   help="Warper norm layer: Batch / Instance / Spectral")
    p.add_argument("--warper-num-layers", type=int, default=d.warper_num_layers)
    p.add_argument("--bn-mode", type=str, default=d.bn_mode,
                   choices=("frozen", "batch"),
                   help="backbone BN: frozen running stats (default) or the "
                        "reference's train-mode batch statistics")
    _add_bool_flag(p, "optim-dup-quirk", d.optim_dup_quirk,
                   "Mirror the reference's duplicate-param SGD dynamics.")
    p.add_argument("--cpu", action="store_true", default=d.cpu,
                   help="choose to use cpu device.")
    p.add_argument("--num-devices", type=int, default=d.num_devices)
    p.add_argument("--profile-dir", type=str, default=d.profile_dir)
    p.add_argument("--compute-dtype", type=str, default=d.compute_dtype)
    _add_bool_flag(p, "orbax-checkpoints", d.orbax_checkpoints,
                   "Save the full train state (torch.save) beside the .pth "
                   "snapshots and resume from the latest (flag name kept "
                   "from the JAX package).")
    return p


def parse_args(argv=None) -> TrainConfig:
    ns = build_parser().parse_args(argv)
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: v for k, v in vars(ns).items() if k in fields})
