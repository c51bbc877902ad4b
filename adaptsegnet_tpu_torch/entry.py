"""The port's compile check and multi-device dry run.

Counterpart of the repository root's `__graft_entry__.py` for the JAX
package:

entry() -> (fn, example_args): the DeeplabMulti forward (ResNet-101
DeepLab-v2 with two ASPP heads) at the JAX entry's example shape, an
NHWC batch of one 256x512 image, in the port's layout: `fn(model,
images) -> (pred1, pred2)`, NHWC stride-8 logits.

dryrun_multichip(n): launches n data-parallel ranks (parallel/group.py)
and runs ONE multi-level adversarial train step (G + D1 + D2 forward and
backward, the gradient all-reduce, all three optimizers) on a global batch
of n tiny images, one per rank, then ONE source-only step with the Warper
(the fork's default mode), at the JAX dry run's shapes; prints
`dryrun_multichip ok`.
"""

from __future__ import annotations

import numpy as np
import torch

EXAMPLE_SHAPE = (1, 256, 512, 3)  # the JAX entry's example input
DRYRUN_HW = (64, 128)


def entry(device: str | torch.device | None = None):
    """(fn, (model, images)): the DeeplabMulti forward, weights drawn from
    seed 0, on the card (or `device`)."""
    from adaptsegnet_tpu_torch.models import DeeplabMulti

    model = DeeplabMulti(num_classes=19, device=device,
                         generator=torch.Generator().manual_seed(0))
    x = torch.zeros(EXAMPLE_SHAPE, device=next(model.parameters()).device)

    @torch.inference_mode()
    def fn(model, images):
        pred1, pred2 = model(images)
        return pred1, pred2

    return fn, (model, x)


def _dryrun_rank(n_devices: int, cpu: bool) -> dict:
    """One multi-level step, then one Warper source-only step, as one rank
    of the group; returns the global metrics of both."""
    from adaptsegnet_tpu_torch.device import resolve_device
    from adaptsegnet_tpu_torch.parallel import group
    from adaptsegnet_tpu_torch.train.build import build_train_state
    from adaptsegnet_tpu_torch.train.config import TrainConfig
    from adaptsegnet_tpu_torch.train.steps import (
        make_adversarial_step,
        make_source_only_step,
    )

    device = resolve_device("cpu" if cpu else None)
    hw = DRYRUN_HW
    size = f"{hw[1]},{hw[0]}"
    rng = np.random.default_rng(0)  # the global batch, sliced by rank
    images = rng.standard_normal((1, n_devices, *hw, 3)).astype(np.float32)
    labels = rng.integers(0, 19, size=(1, n_devices, *hw))
    target = rng.standard_normal((1, n_devices, *hw, 3)).astype(np.float32)
    r = group.rank()
    batch = {k: torch.from_numpy(v[:, r:r + 1]).to(device) for k, v in
             (("images", images), ("labels", labels),
              ("target_images", target))}

    cfg = TrainConfig(source_only=False, level="multi-level", warper=False,
                      restore_from="", input_size=size,
                      input_size_target=size, num_steps=100,
                      batch_size=n_devices, num_devices=n_devices, cpu=cpu)
    state = build_train_state(cfg, device)
    group.broadcast_state(state)
    metrics = make_adversarial_step(level="multi-level", input_hw=hw)(
        state, batch)
    out = {k: float(v) for k, v in metrics.items()}

    cfg_w = TrainConfig(source_only=True, warper=True, warper_num_layers=5,
                        restore_from="", input_size=size, num_steps=100,
                        batch_size=n_devices, num_devices=n_devices, cpu=cpu)
    state_w = build_train_state(cfg_w, device)
    group.broadcast_state(state_w)
    metrics_w = make_source_only_step(input_hw=hw)(
        state_w, {k: batch[k] for k in ("images", "labels")})
    out_w = {k: float(v) for k, v in metrics_w.items()}
    for name, vals in (("", out), (" warper", out_w)):
        for k, v in vals.items():
            assert np.isfinite(v), f"non-finite{name} metric {k}"
    return {"multi-level": out, "source-only warper": out_w}


def dryrun_multichip(n_devices: int, cpu: bool = False,
                     timeout: float | None = 1200.0) -> dict:
    """One data-parallel multi-level step and one Warper source-only step
    on `n_devices` ranks: one per card (NCCL; raises with fewer cards), or
    gloo processes on the CPU with `cpu`. Returns rank 0's metrics."""
    from adaptsegnet_tpu_torch.parallel import group

    if not cpu and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip: need {n_devices} CUDA devices, "
            f"{torch.cuda.device_count()} visible (cpu=True runs gloo ranks "
            "on the CPU)")
    results = group.launch(_dryrun_rank, n_devices, cpu=cpu,
                           args=(n_devices, cpu), timeout=timeout)
    if any(r != results[0] for r in results):
        raise RuntimeError(f"dryrun_multichip: ranks disagree: {results}")
    print("dryrun_multichip ok:", results[0]["multi-level"])
    print("dryrun_multichip warper ok:", results[0]["source-only warper"])
    return results[0]
