"""Training driver: config -> data -> step -> snapshots and logging.

Counterpart of adaptsegnet_tpu/train/loop.py (`train` :120-269; reference
train_gta2cityscapes_multi.py:180-729), on one device or as one rank of a
data-parallel group (parallel/group.py; cli/train.py launches the ranks).
The source domain is GTA5 or, with --source Synscapes, Synscapes. Batches come from the
prefetching loader, collated to the step layout (iter_size, B, ...). The
loss line of step i is printed after step i+1 is enqueued, so reading the
metrics (a device sync) overlaps the next step. Snapshots keep the
reference's .pth naming per mode subdir (source_only / single_level /
multi_level); with --orbax-checkpoints the full state (the Warper's
running statistics included, where the mode builds it) is saved beside them
and the latest one is resumed. SIGTERM / SIGINT end the run with a final
snapshot.

In a group of W ranks each rank loads its interleaved slice of every
global batch (B / W images per step), and all ranks start from rank 0's
state: the latest full state that rank 0 finds (its file's bytes are
broadcast, so the other ranks need not see rank 0's snapshot directory),
else the state rank 0 built. Rank 0 alone writes the .pth snapshots, the full state, the tensorboard scalars, the loss lines
and the profile. A signal ends the run at the same step on every rank: a
rank's stop vote rides in the step's metrics all-reduce, and all ranks read
the summed vote one step behind, with the loss line (a rank that left the
loop alone would hang the others in their next collective).
"""

from __future__ import annotations

import os
import os.path as osp
import signal
import time
from typing import Optional

import numpy as np
import torch

from adaptsegnet_tpu_torch.data import (
    CityscapesDataset,
    GTA5Dataset,
    PrefetchLoader,
    SynscapesDataset,
)
from adaptsegnet_tpu_torch.device import resolve_device
from adaptsegnet_tpu_torch.parallel import group
from adaptsegnet_tpu_torch.train.build import build_train_state
from adaptsegnet_tpu_torch.train.config import TrainConfig
from adaptsegnet_tpu_torch.train.steps import (
    make_adversarial_step,
    make_source_only_step,
)
from adaptsegnet_tpu_torch.utils.checkpoint import (
    FullStateCheckpoints,
    save_snapshot_pth,
)
from adaptsegnet_tpu_torch.utils.logging import ScalarLogger, format_losses


def mode_subdir(cfg: TrainConfig) -> str:
    if cfg.source_only:
        return "source_only"
    return {"single-level": "single_level", "multi-level": "multi_level"}[
        cfg.level]


def _loaders(cfg: TrainConfig, device: torch.device):
    """The source loader and, for the adversarial modes, the target one;
    batches shaped (iter_size, B / W, ...), the rank's slice of the global
    batch."""
    max_iters = cfg.num_steps * cfg.iter_size * cfg.batch_size
    local_bs = cfg.batch_size // group.world()
    per_step = cfg.iter_size * local_bs
    ishape = (cfg.iter_size, local_bs)
    slicing = dict(process_index=group.rank(), process_count=group.world())

    def collate_source(items):
        img = np.stack([it[0] for it in items])
        lab = np.stack([it[1] for it in items]).astype(np.int64)
        return {"images": img.reshape(ishape + img.shape[1:]),
                "labels": lab.reshape(ishape + lab.shape[1:])}

    def collate_target(items):
        img = np.stack([it[0] for it in items])
        return {"target_images": img.reshape(ishape + img.shape[1:])}

    source_cls = {"GTA5": GTA5Dataset, "Synscapes": SynscapesDataset}[cfg.source]
    source = source_cls(cfg.data_dir, cfg.data_list, max_iters=max_iters,
                        crop_size=cfg.crop_size_wh, scale=cfg.random_scale,
                        mirror=cfg.random_mirror, seed=cfg.random_seed)
    loaders = [PrefetchLoader(source, per_step, collate_source, device,
                              seed=cfg.random_seed,
                              num_workers=cfg.num_workers, **slicing)]
    if not cfg.source_only:
        target = CityscapesDataset(
            cfg.data_dir_target, cfg.data_list_target,
            crop_size=cfg.crop_size_wh_target, set=cfg.set,
            max_iters=max_iters, mirror=cfg.random_mirror,
            seed=cfg.random_seed)
        loaders.append(PrefetchLoader(target, per_step, collate_target, device,
                                      seed=cfg.random_seed + 1,
                                      num_workers=cfg.num_workers, **slicing))
    return loaders


def _resume_or_replicate(state, full: Optional[FullStateCheckpoints],
                         device: torch.device) -> bool:
    """Start every rank from rank 0's state: the latest full state rank 0
    finds in `full` (None: no full-state checkpoints), else the state rank 0
    built. Returns whether a full state was resumed."""
    data = (full.read_latest() if full is not None and group.rank() == 0
            else None)
    data = group.broadcast_bytes(data, device)
    if data is None:
        group.broadcast_state(state)
        return False
    FullStateCheckpoints.load_bytes(state, data)
    return True


def train(cfg: TrainConfig, max_steps: Optional[int] = None) -> dict:
    """Run training; returns a summary (final losses, snapshot paths)."""
    device = resolve_device("cpu" if cfg.cpu else None)
    torch.manual_seed(cfg.random_seed)
    state = build_train_state(cfg, device)
    lead = group.rank() == 0
    voting = group.world() > 1  # the stop decision rides in the metrics
    if cfg.source_only:
        step_fn = make_source_only_step(cfg.input_hw, cfg.iter_size)
    else:
        step_fn = make_adversarial_step(
            level=cfg.level, gan=cfg.gan,
            lambda_seg=cfg.lambda_seg, lambda_adv1=cfg.lambda_adv_target1,
            lambda_adv2=cfg.lambda_adv_target2, input_hw=cfg.input_hw,
            iter_size=cfg.iter_size)

    sub = mode_subdir(cfg)
    logger = ScalarLogger(cfg.log_dir, cfg.tensorboard and lead)
    full = (FullStateCheckpoints(osp.join(cfg.snapshot_dir, sub, "full_state"))
            if cfg.orbax_checkpoints else None)
    if _resume_or_replicate(state, full, device) and lead:
        print(f"resumed the full state at step {state.step}")

    stop = min(cfg.num_steps_stop, max_steps or cfg.num_steps_stop)
    loaders = _loaders(cfg, device)
    snapshots: list[str] = []

    def snapshot(tag: int):
        if not lead:
            return
        snapshots.append(save_snapshot_pth(cfg.snapshot_dir, sub, tag,
                                           state.model, state.d1, state.d2))
        if full is not None:
            full.save(tag, state)

    stop_requested: list[int] = []
    old_handlers = {sig: signal.signal(sig, lambda s, f: stop_requested.append(s))
                    for sig in (signal.SIGTERM, signal.SIGINT)}
    pending = None  # (i_iter, device metrics of the previous step)
    host: dict = {}
    times: list[float] = []
    # the vote's tensor is filled in place each step: a new tensor from a
    # host value would wait for the card to finish the previous step
    vote = torch.zeros((), device=device) if voting else None

    def emit(item):
        it, dev = item
        vals = {k: float(v) for k, v in dev.items()}
        votes = vals.pop("stop", 0.0)
        if lead:
            print(f"exp = {cfg.snapshot_dir}")
            print(format_losses(it, cfg.num_steps, vals))
            logger.log(it, vals)
        return vals, votes > 0

    profiler = None
    start = state.step
    try:
        for i_iter in range(start, stop):
            if cfg.profile_dir and lead and i_iter == start + 3:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if device.type == "cuda" else [])])
                profiler.start()
            batch = {}
            for loader in loaders:
                batch.update(next(loader))
            t0 = time.perf_counter()
            if voting:
                vote.fill_(float(bool(stop_requested)))
            metrics = step_fn(state, batch, {"stop": vote} if voting else None)
            agreed = False
            if pending is not None:
                # waits for step i-1 while step i runs
                host, agreed = emit(pending)
                times.append(time.perf_counter() - t0)
            pending = (i_iter, metrics)
            if profiler is not None and (i_iter == start + 6
                                         or i_iter >= stop - 1):
                profiler.stop()
                os.makedirs(cfg.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(
                    osp.join(cfg.profile_dir, "trace.json"))
                profiler = None

            if agreed if voting else stop_requested:
                if lead:
                    sig = stop_requested[0] if stop_requested else "(another rank's)"
                    print(f"signal {sig} received; snapshotting ...")
                snapshot(i_iter + 1)
                break
            if i_iter >= stop - 1:
                if lead:
                    print("save model ...")
                snapshot(stop)
                break
            if i_iter % cfg.save_pred_every == 0 and i_iter != 0:
                if lead:
                    print("taking snapshot ...")
                snapshot(i_iter)
        if pending is not None:
            host, _ = emit(pending)
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
        for loader in loaders:
            loader.close()
        logger.close()
    if times and lead:
        print(f"step time (host clock, one step behind): median "
              f"{1e3 * float(np.median(times)):.1f} ms")
    return {"final_metrics": host, "snapshots": snapshots, "steps": stop}
