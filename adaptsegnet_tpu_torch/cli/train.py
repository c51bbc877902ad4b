"""`python -m adaptsegnet_tpu_torch.cli.train <flags>` — training on the CUDA
card (`--cpu` for the CPU).

The JAX package's flag surface (reference train_gta2cityscapes_multi.py:
72-156) with the mode constants as real flags (--source-only /
--no-source-only, --level). With no flags it trains the fork's default
mode: source-only with the Warper (Batch norm, 8 layers). Single-level with
or without the Warper and multi-level run too, as do --bn-mode batch,
--optim-dup-quirk, --model DeeplabVGG (single-level), --source Synscapes and
--tensorboard.

Data parallelism: `--num-devices N` (0, the default, = every visible card)
runs W = `auto_world_size(--batch-size, N, cards)` ranks, one process per
card (NCCL; gloo with --cpu, where N counts processes), each on B / W
images of the global batch B; W = 1 keeps the single-process path with no
group. Started by `torchrun --nproc-per-node W -m
adaptsegnet_tpu_torch.cli.train ...`, each process joins torchrun's group
instead.
"""

from __future__ import annotations

import numpy as np

from adaptsegnet_tpu_torch.parallel import group
from adaptsegnet_tpu_torch.train.config import parse_args, world_size
from adaptsegnet_tpu_torch.train.loop import train


def main(argv=None):
    cfg = parse_args(argv)
    np.random.seed(cfg.random_seed)
    ranks = world_size(cfg)
    if ranks > 1 or group.started_by_torchrun():
        return group.launch(train, ranks, cpu=cfg.cpu, args=(cfg,))[0]
    return train(cfg)


if __name__ == "__main__":
    main()
