"""`python -m adaptsegnet_tpu_torch.cli.train <flags>` — training on the CUDA
card (`--cpu` for the CPU).

The JAX package's flag surface (reference train_gta2cityscapes_multi.py:
72-156) with the mode constants as real flags (--source-only /
--no-source-only, --level). With no flags it trains the fork's default
mode: source-only with the Warper (Batch norm, 8 layers). Single-level with
or without the Warper and multi-level run too, as do --bn-mode batch,
--optim-dup-quirk, --model DeeplabVGG (single-level), --source Synscapes and
--tensorboard; only more than one device still raises.
"""

from __future__ import annotations

import numpy as np

from adaptsegnet_tpu_torch.train.config import parse_args
from adaptsegnet_tpu_torch.train.loop import train


def main(argv=None):
    cfg = parse_args(argv)
    np.random.seed(cfg.random_seed)
    return train(cfg)


if __name__ == "__main__":
    main()
