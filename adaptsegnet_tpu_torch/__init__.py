"""PyTorch/CUDA port of adaptsegnet_tpu for NVIDIA Hopper (H100).

The JAX package `adaptsegnet_tpu` is the reference; this package computes
the same functions with PyTorch, and each TPU (Pallas) kernel on a ported
path is a hand-written CUDA kernel under `csrc/`. The port imports neither
JAX nor anything of `adaptsegnet_tpu`.

Slices ported so far: DeeplabMulti evaluation (forward -> align-corners
upsample -> first-index argmax -> uint8 masks -> PNGs -> mIoU), entry point
`python -m adaptsegnet_tpu_torch.cli.evaluate`; and training without the
Warper (the multi-level adversarial step with D1/D2, single-level,
source-only), entry point `python -m adaptsegnet_tpu_torch.cli.train`.
"""
