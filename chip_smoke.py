#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card and check them.

    python3 chip_smoke.py                 # from the repository root; one card
    python3 chip_smoke.py --kernels-only  # phases 1-3 and 8 only: build the
                                          # kernels and hold each against its
                                          # plain version (no contract lines)
    python3 chip_smoke.py --data-parallel-only  # phases 1-3, 9, 12 and 14
                                                # (no contract lines)
    python3 chip_smoke.py --multi-card    # phases 1, 2 and 15 on four cards
                                          # (exits nonzero with fewer; no
                                          # contract lines)

The port's main paths are DeeplabMulti evaluation (ResNet-101 forward at
512x1024 -> align-corners upsample to 1024x2048 -> first-index argmax ->
uint8 masks -> PNGs -> mIoU; one image at a time, and a bf16 batch of four,
whose layer2..layer4 3x3 convs take the batched kernel 3), the bf16
multi-level adversarial train step
(DeeplabMulti + D1/D2 at 512x1024, bs 1) and the fork's default train mode,
the bf16 source-only step with the Warper (DeeplabMulti + an 8-layer
Warper at 512x1024, bs 1). Phases, each printing one line or more (any
failure exits nonzero, and there is no CPU fallback):
  1. device, torch and CUDA versions, nvidia-smi name and power limit;
  2. build the five CUDA libraries (six TPU kernels' counterparts) from
     adaptsegnet_tpu_torch/csrc (one nvcc each, started together), with
     each kernel's registers and spill bytes from ptxas (the Hopper core's
     conv_sm90_kernel variants, kernel 5's wgrad_sm90_kernel, kernel 4's
     fwd_kernel, dgrad_kernel and wgrad_kernel, the rest);
  3. hold kernel 1 against its plain PyTorch version on the card (five
     shapes, 5 to 100 channels, two dtypes, the first-index tie), then time
     it at the eval shape in bf16 and f32, with 19 classes and with 16, as
     phase 8 times its kernels (wrapper, host enqueue, profiled device
     time, plain, F.interpolate + argmax, bound);
  4. full-width bf16 eval through make_eval_fn (kernel 1's main path):
     launch counts zeroed before, read after; kernel tail vs plain tail;
     four single images (no kernel-3 launch), then the same four as one
     batch (kernel 3's main path: 30 launches, kernel 1 once), its logits
     and masks held against the single-image path's, the batch timed with
     kernel 3, with cuDNN in its place and as four single images, and a
     profiler window over the batched forward;
  5. f32 eval on the card vs the CPU, same weights, 256x512 -> 512x1024
     (catches TF32 left on);
  6. the CLI: cli.evaluate on synthetic Cityscapes, then cli.iou;
  7. timings with CUDA events after warm-up, a torch.profiler window over
     the eval (device-busy share, launches, top kernels), and the
     Evaluator's steady end-to-end rate with host decode and PNG writes
     (two runs of 20 and 120 images differenced, so the pipeline's fill
     and drain are timed apart);
  8. every direction of the conv and warp kernels (2: conv3x3_dil fwd/dgrad
     at layer3 and layer4; 3: the batched forward at N = 4 for layer2, layer3
     and layer4, at the Oracle's 65x129 map and at N = 8 with nb chosen and
     forced to 2; 5: conv4x4_s2 fwd/dgrad/wgrad at D conv2..4, and
     its forward at the seven Warper encoder shapes down1..out; 4:
     conv4x4_patch fwd/dgrad/wgrad at D conv1; 6: upsample_warp fwd/dx/
     d-flow at (1, 64, 128, 19) -> 512x1024 in bf16 and f32, on the
     Warper's flow with clamped-edge and exact-boundary sample positions
     added, each line with the share of pixels in their tile's window;
     then, checked and timed but not in the kernels line, on a raw flow
     drawn N(0, 0.5) that moves most pixels out of their window and at
     the edge shape (2, 33, 65, 19) -> 257x519) against
     its plain version at the train shapes, with its wrapper time, the
     host's enqueue time, its profiled device time, the plain version's
     time, the library call's and its bound (the rows of kernels 2 and 3
     name the tile that `tile_plan` chose, the wgrads' the pixel split
     that their `wgrad_plan` chose); then kernel 4's three directions,
     checked but not timed, at shapes off the main path (masked last tiles
     of a row, W not a multiple of 8, two images, a wgrad split of two
     steps); last, kernel 6's dx cell by cell, each by its own magnitude,
     on the Warper's flow with cotangents that spread by 1e4 and more
     within a tile;
  9. the bf16 multi-level train step at 512x1024 (the train slice's main
     path): launch counts zeroed before 10 timed steps and read after,
     checked against the per-step counts; finite losses, loss_seg2 ~ ln 19
     at step 0, parameters moved; ms/step by CUDA events, peak memory, and
     a profiler window (device-busy share, launches/step);
 10. one step card vs CPU from the same weights, bf16 and f32: multi-level,
     source-only and single-level with a 7-layer Warper, and multi-level
     with bn_mode='batch' at one bottleneck per stage;
 11. the CLI: cli.train (bf16 multi-level, 3 steps, synthetic data) writes
     GTA5_3.pth + _D1/_D2, then cli.evaluate loads GTA5_3.pth; the same
     with cli.train's default mode flags (source-only with the Warper),
     single-level with the Warper, --bn-mode batch, --optim-dup-quirk,
     --model DeeplabVGG --no-source-only and --source Synscapes;
 12. the bf16 source-only Warper step at 512x1024 (the fork's default
     mode), as phase 9: launch counts zeroed before 10 timed steps and
     checked after (kernel 6: 1 fwd + 1 dx, no d-flow), loss_seg2 ~ ln 19
     at step 0, G parameters and the Warper's BN statistics moved, its
     weights unchanged; ms/step, peak memory, a profiler window; then 3
     f32 steps of the same mode;
 13. the other two segmenters: bf16 eval of DeeplabSingle (the Oracle) on a
     batch of two at 512x1024 (kernel 3 on its 65x129 maps, 30 launches),
     held against single-image eval; f32 DeeplabVGG card vs CPU at 256x512;
     cli.evaluate --model Oracle and --model DeeplabVGG, then cli.iou;
 14. data parallelism (parallel/group.py) on the one card: (a) the bf16
     multi-level and source-only Warper steps at 512x1024 as the one rank
     of an NCCL group (parallel.launch), one step each against the
     no-group step from the same seeded state: bit for bit, but that
     kernel 6's dx is not bit-reproducible, so the source-only update is
     held to the bf16 limits of PERF.md §2; launches per step as phases 9
     and 12, and ms/step (CUDA events) beside theirs; the train loop's
     full-state resume through NCCL exact; (b) two gloo ranks,
     both on cuda:0 (NCCL refuses two ranks on one card, so gloo is the
     only way to run the multi-rank path here), each on its half of a
     global batch of 2, against the 1-process step on that batch: the same
     two steps at full width to the bf16 limits, and the f32 multi-level
     step with bn_mode='batch' at phase 10's size and depth to the f32
     limits; each rank's launches per step equal phases 9 / 12's; (c) two
     gloo ranks: f32 Evaluator.run_streaming of 5 images at a global batch
     of 2, histogram and PNGs equal to the 1-process run at batch 1, and
     each rank's bf16 batched pair (kernels 3 and 1) bit for bit with the
     1-process forward of that pair; (d) `python -m
     adaptsegnet_tpu_torch.cli.profile_step --iters 3`: the table names the
     hand-written kernels, the wrappers' launches over the trace are 3 x
     phase 9's per step (the table in _smoke_out/profile_step.txt); (e)
     entry() on the card. A failing rank fails the phase.
Then a `{"kernels": [...]}` line, the nvidia-smi line, and the last line
`{"ok": true, "device": {...}}`.

With --multi-card, after phases 1 and 2 (phase 1 prints nvidia-smi's line
for each card), on four cards, one NCCL rank each (parallel.launch), each
number beside the four cards' nvidia-smi lines:
 15. data parallelism across the cards: (a) the bf16 multi-level and
     source-only Warper steps at 512x1024 and the f32 multi-level step
     with bn_mode='batch' at phase 10's size and depth, on a global batch
     of 4 (one image per card) from the seeded state, against one process
     on card 0 with the whole batch (PERF.md §2's bf16 / f32 limits on the
     losses, each module's gradient and its update; a discriminator's
     update leaves out the weights whose Adam sign the summation order
     picks, and counts them); every parameter, buffer and optimizer state
     equal on all ranks after 3 steps; each rank's launches per step equal
     phases 9 / 12's; ms/step by CUDA events per rank beside the one-card
     step at batch 1 and 4, peak memory per card, rank 0's profiler
     window (device busy, the NCCL kernels' device ms per step), and the
     gradient all-reduce alone with the ranks aligned; (b) the
     bf16 multi-level full state saved by rank 0 and resumed through NCCL
     on every card, exact; (c) cli.train --num-devices 4 --batch-size 4, 3
     steps, multi-level and the default mode flags, then cli.evaluate on
     GTA5_3.pth; the multi-level command under `python -m
     torch.distributed.run --standalone --nproc-per-node 4` (torchrun),
     its snapshots and loss lines equal to the spawned run's bit for bit;
     (d) cli.evaluate --num-devices 4 (f32) on 9 images against
     --num-devices 1: PNGs and cli.iou exact; the group's run_streaming
     histogram against one process; each rank's bf16 batched pair (kernels
     3 and 1) bit for bit, and img/s on four cards beside one. A failing
     rank fails the phase; there is no gloo fallback.

Weights come from a fixed torch.Generator with the reference's init law
(conv weights N(0, 0.01)); the frozen-BN statistics are then drawn from the
same generator, checkpoint-like, because at init (scale 1, mean 0, var 1)
the logits of the 101-layer net nearly vanish and every mask would be one
class. Images are made with numpy from a seed.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "_smoke_work")  # git-ignored scratch, removed at exit
OUT = os.path.join(REPO, "_smoke_out")  # git-ignored, kept: output too long to print
EVAL_IN, EVAL_OUT = (512, 1024), (1024, 2048)
SEED = 0
# Kernel-3 launches of one batched bf16 ResNet-101 forward: the stride-1 3x3
# convs of layer2 (4 blocks, C 128, d 1), layer3 (23, C 256, d 2) and layer4
# (3, C 512, d 4); layer1's have 64 channels and keep cuDNN.
BATCHED_EVAL_LAUNCHES = 4 + 23 + 3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_cards(query: str = "name,power.limit") -> list[str]:
    """nvidia-smi's line for each visible card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()


def nvidia_smi(query: str = "name,power.limit") -> str:
    return nvidia_smi_cards(query)[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls, by CUDA
    events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_window(fn, iters: int):
    """torch.profiler over `iters` calls of fn after one warm-up -> (wall ms
    per call, the device events, kernel launches per call). The device
    events are kernels, device copies and the device spans of user
    annotations (see busy_split); a CPU op's own entry, which repeats the
    device time of the kernels it launched, is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.device_time_total > 0]
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC", "cuLaunchKernelEx")) / iters
    return wall_ms, device, launches


def profile_eval(fn, iters: int = 5) -> str:
    """Where one eval's time goes: torch.profiler over `iters` calls after
    one warm-up -> wall and device-busy ms per call, kernel launches per
    call, and the five kernels with the most device time."""
    wall_ms, device, launches = profile_window(fn, iters)
    busy_ms = sum(e.device_time_total for e in device) / 1e3 / iters
    if not device:
        return (f"wall {wall_ms:.3f} ms/call; device time not measured (the "
                "profiler saw no device events)")
    top = sorted(device, key=lambda e: -e.device_time_total)[:5]
    tops = "; ".join(
        f"{e.key[:60]} {e.device_time_total / 1e3 / iters:.3f} ms "
        f"({e.count // iters}x)" for e in top)
    return (f"wall {wall_ms:.3f} ms/call, device busy {busy_ms:.3f} ms/call "
            f"({100 * busy_ms / wall_ms:.1f} %), {launches:g} kernel "
            f"launches/call; top: {tops}")


def checkpoint_like_bn_(model, generator: torch.Generator) -> None:
    from adaptsegnet_tpu_torch.models.layers import FrozenBatchNorm2d

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm2d):
                c = m.weight.numel()
                m.weight.copy_(torch.rand(c, generator=generator) + 0.5)
                m.bias.copy_(torch.randn(c, generator=generator) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=generator))
                m.running_var.copy_(torch.rand(c, generator=generator) * 1.5 + 0.5)


def make_images(n: int, hw: tuple[int, int], seed: int) -> np.ndarray:
    """Random RGB images through the dataset's preprocessing (BGR, minus
    the Caffe mean), NHWC f32."""
    from adaptsegnet_tpu_torch.data.preprocessing import preprocess_image

    rng = np.random.default_rng(seed)
    return np.stack([
        preprocess_image(rng.integers(0, 256, hw + (3,)).astype(np.float32))
        for _ in range(n)
    ])


def compare_masks(kernel_mask, plain_up, f32: bool) -> tuple[float, float]:
    """Kernel masks vs the plain version's upsampled f32 logits.

    f32: >= 99.99 % equal, every mismatch at a plain top-2 margin < 1e-5;
    bf16: >= 99.9 % and < 1e-2 (sums run in another order in the kernel and
    in the matmuls, so only near-ties may flip). Returns (agreement, max
    logit error): the plain logit of the plain argmax minus the plain logit
    of the kernel's choice, the largest over pixels (0 where they agree).
    """
    plain_mask = plain_up.argmax(-1)
    eq = kernel_mask.long() == plain_mask
    agree = eq.float().mean().item()
    top2 = plain_up.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    chosen = plain_up.gather(-1, kernel_mask.long().unsqueeze(-1)).squeeze(-1)
    err = (top2[..., 0] - chosen).max().item()
    need, tol = (0.9999, 1e-5) if f32 else (0.999, 1e-2)
    bad_margin = margin[~eq].max().item() if (~eq).any() else 0.0
    check(agree >= need and bad_margin < tol,
          f"masks agree {agree:.6f} (need {need}), largest mismatch margin "
          f"{bad_margin:.3g} (need < {tol})")
    return agree, err


@contextlib.contextmanager
def library_3x3():
    """Inside, the gate of the batched 3x3 kernel answers no, so a batched
    bf16 forward keeps cuDNN for those convs: this script's yardstick for
    kernel 3 on its main path. The port itself has no such switch."""
    from adaptsegnet_tpu_torch.ops.kernels import conv3x3_dil

    real = conv3x3_dil.supported_batched
    conv3x3_dil.supported_batched = lambda *args, **kwargs: False
    try:
        yield
    finally:
        conv3x3_dil.supported_batched = real


def hold_batch_against_singles(forward, images, batch_masks, singles) -> str:
    """Hold a batched bf16 eval (kernel 3 on layer2..layer4) against the
    single-image path (`singles`: its logits per image, every conv on cuDNN).

    The two run the same f32-accumulated convs in other sum orders, so each
    bf16 rounding may fall the other way and the difference grows through
    the 101 layers like any bf16 noise. Held: the logits' relative L2
    difference <= 2e-2 (the bf16 tolerance of the train-step parity) and no
    more than twice that of the same batch with those convs on cuDNN (the
    noise of batching alone) plus 2e-3; the masks (kernel 1's, on the
    batch's logits) >= 99 % equal to the single-image path's plain argmax,
    and different only where that path's top-2 margin is below twice the
    largest logit difference of the image (a flip needs that) + 1e-2
    (kernel 1's own bf16 rule). Returns the line to print."""
    from adaptsegnet_tpu_torch.ops.resize import resize_bilinear_align_corners

    n = images.shape[0]
    with torch.inference_mode():
        ours = forward(images).float()
        with library_3x3():
            lib = forward(images).float()
    ref = torch.cat(singles).float()
    rel = lambda a: ((a - ref).norm() / ref.norm()).item()
    ours_rel, lib_rel = rel(ours), rel(lib)
    check(ours_rel <= 2e-2 and ours_rel <= 2 * lib_rel + 2e-3,
          f"batched logits differ from the single-image path's by {ours_rel:.3g} "
          f"relative L2 (the cuDNN batch by {lib_rel:.3g})")
    agrees, worst_margin, worst_diff = [], 0.0, 0.0
    for i in range(n):
        up = resize_bilinear_align_corners(ref[i:i + 1], tuple(batch_masks.shape[1:]))
        eq = batch_masks[i:i + 1].long() == up.argmax(-1)
        top2 = up.topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1])[~eq]
        diff = (ours[i] - ref[i]).abs().max().item()
        bad = margin.max().item() if margin.numel() else 0.0
        agree = eq.float().mean().item()
        check(agree >= 0.99 and bad < 2 * diff + 1e-2,
              f"batch image {i}: masks agree {agree:.6f} with the single-image "
              f"path (need 0.99); largest top-2 margin at a mismatch {bad:.3g}, "
              f"largest logit difference {diff:.3g}")
        agrees.append(agree)
        worst_margin, worst_diff = max(worst_margin, bad), max(worst_diff, diff)
    return (f"logits vs the single-image path (cuDNN): relative L2 "
            f"{ours_rel:.3g} (the same batch with cuDNN 3x3s: {lib_rel:.3g}; "
            f"<= 2e-2 and <= twice that + 2e-3), largest |logit| "
            f"{ref.abs().max().item():.3g}, largest difference {worst_diff:.3g}; "
            f"masks equal at min {min(agrees):.6f} of the pixels (>= 0.99), "
            f"largest top-2 margin at a mismatch {worst_margin:.3g} (< twice "
            f"the image's largest logit difference + 1e-2)")


def upsample_argmax_work(logits, out_hw) -> tuple[int, int]:
    """(operations, bytes) of the least work of kernel 1's function: read
    the logits and the 4 weight tables once, write the mask once; per
    output pixel and channel a width lerp (mul + fma = 3 flops) and a
    compare, per output row, needed source column and channel a height
    lerp (3 flops)."""
    n, h, w, c = logits.shape
    oh, ow = out_hw
    nbytes = (logits.numel() * logits.element_size() + n * oh * ow
              + 8 * (2 * oh + 2 * ow))
    return n * oh * ow * c * 4 + n * oh * w * c * 3, nbytes


def phase_kernels(results: dict, smi: str) -> None:
    from adaptsegnet_tpu_torch.ops.kernels import (
        upsample_argmax,
        upsample_argmax_plain,
    )
    from adaptsegnet_tpu_torch.ops.resize import resize_bilinear_align_corners

    rng = np.random.default_rng(SEED)
    cases = [((1, 64, 128, 19), EVAL_OUT), ((2, 8, 16, 19), (32, 256)),
             ((1, 4, 8, 5), (4, 8)), ((1, 64, 128, 16), EVAL_OUT),
             ((2, 5, 7, 100), (17, 29))]
    before = upsample_argmax.launches
    launched, worst = 0, 0.0
    for shape, out_hw in cases:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            x = x.to("cuda", dtype)
            mask = upsample_argmax(x, out_hw)
            launched += 1
            torch.cuda.synchronize()
            check(mask.dtype == torch.uint8 and mask.shape == (shape[0],) + out_hw,
                  f"kernel output {mask.dtype} {tuple(mask.shape)}")
            up = resize_bilinear_align_corners(x.float(), out_hw, exact=True)
            agree, err = compare_masks(mask, up, dtype == torch.float32)
            worst = max(worst, err)
            print(f"phase 3: upsample_argmax {shape}->{out_hw} {dtype}: "
                  f"agreement {agree:.6f}, max logit error {err:.3g}")
    tie = torch.zeros((1, 4, 8, 3), device="cuda")
    tie[..., 1] = 5.0
    tie[..., 2] = 5.0
    check(bool((upsample_argmax(tie, (8, 16)) == 1).all()),
          "tie must pick the first maximal channel")
    check(bool((upsample_argmax_plain(tie, (8, 16)) == 1).all()),
          "plain tie must pick the first maximal channel")
    launched += 1
    check(upsample_argmax.launches - before == launched,
          f"launch counter grew by {upsample_argmax.launches - before}, "
          f"expected {launched}")
    results["max_abs_err"] = worst
    for shape, dtype in ((cases[0][0], torch.bfloat16), (cases[0][0], torch.float32),
                         (cases[3][0], torch.bfloat16), (cases[3][0], torch.float32)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(  # timed
            np.float32)).to("cuda", dtype)
        ops, nbytes = upsample_argmax_work(x, EVAL_OUT)
        times = time_kernel(
            lambda: upsample_argmax(x, EVAL_OUT),
            lambda: upsample_argmax_plain(x, EVAL_OUT),
            lambda: F.interpolate(x.permute(0, 3, 1, 2).float(), EVAL_OUT,
                                  mode="bilinear", align_corners=True)
            .argmax(1).to(torch.uint8), ops, nbytes, PEAK_F32)
        print(f"phase 3: upsample_argmax {tuple(x.shape)}->{EVAL_OUT} {dtype} "
              f"(library: F.interpolate + argmax): {times['line']} [{smi}]")


def build_models(dtypes):
    """One CPU f32 DeeplabMulti with the smoke's weights, and a copy of its
    weights on the card for each compute dtype."""
    from adaptsegnet_tpu_torch.models import DeeplabMulti

    g = torch.Generator().manual_seed(SEED)
    cpu = DeeplabMulti(device="cpu", generator=g)
    checkpoint_like_bn_(cpu, g)
    sd = cpu.state_dict()
    cards = {}
    for dtype in dtypes:
        m = DeeplabMulti(dtype=dtype, device="cuda")
        m.load_state_dict(sd)
        cards[dtype] = m.eval()
    return cpu.eval(), cards


def phase_bf16_eval(model, results: dict, smi: str) -> None:
    from adaptsegnet_tpu_torch.eval.evaluator import make_eval_fn
    from adaptsegnet_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
        upsample_argmax,
    )
    from adaptsegnet_tpu_torch.ops.resize import resize_bilinear_align_corners

    images = torch.from_numpy(make_images(4, EVAL_IN, SEED + 1)).cuda()
    eval_fn = make_eval_fn(model, out_hw=EVAL_OUT, dtype=torch.bfloat16)
    reset_launch_counts()
    masks = [eval_fn(images[i:i + 1]) for i in range(4)]
    torch.cuda.synchronize()
    counts = launch_counts()
    for m in masks:
        check(m.dtype == torch.uint8 and tuple(m.shape) == (1,) + EVAL_OUT,
              f"mask {m.dtype} {tuple(m.shape)}")
    check(counts["upsample_argmax"] == 4,
          f"upsample_argmax launched {counts['upsample_argmax']} times in "
          "4 bf16 eval images, expected 4")
    check(sum(counts.values()) == 4,
          f"single-image bf16 eval launched other kernels: {counts}")
    results["launches"] = counts
    results["path_launches"]["eval 4 single images"] = counts
    # Kernel 3's main path: the same four images as one batch.
    reset_launch_counts()
    batch_masks = eval_fn(images)
    torch.cuda.synchronize()
    batch_counts = launch_counts()
    expected = {"conv3x3_dil_batched_fwd": BATCHED_EVAL_LAUNCHES,
                "upsample_argmax": 1}
    for name, count in batch_counts.items():
        check(count == expected.get(name, 0),
              f"batched bf16 eval launched {name} {count} times, expected "
              f"{expected.get(name, 0)}")
    check(batch_masks.dtype == torch.uint8
          and tuple(batch_masks.shape) == (4,) + EVAL_OUT,
          f"batch masks {batch_masks.dtype} {tuple(batch_masks.shape)}")
    results["path_launches"]["eval batch of 4"] = batch_counts
    worst, agrees, singles = results["max_abs_err"], [], []
    with torch.inference_mode():
        for i in range(4):
            logits = model(images[i:i + 1])[1].contiguous()
            up = resize_bilinear_align_corners(logits.float(), EVAL_OUT)
            agree, err = compare_masks(upsample_argmax(logits, EVAL_OUT), up, False)
            compare_masks(masks[i], up, False)
            agrees.append(agree)
            singles.append(logits)
            worst = max(worst, err)
    results["eval_logits"] = singles[0]
    results["max_abs_err"] = worst
    classes = len(torch.unique(torch.cat(masks)))
    print(f"phase 4: bf16 DeeplabMulti eval 4x{EVAL_IN} -> {EVAL_OUT} uint8 "
          f"masks, launches {counts}, kernel vs plain tail agreement "
          f"min {min(agrees):.6f}, {classes} classes present")
    held = hold_batch_against_singles(lambda x: model(x)[1], images,
                                      batch_masks, singles)
    batch_ms = cuda_ms(lambda: eval_fn(images), iters=10)
    with library_3x3():
        library_ms = cuda_ms(lambda: eval_fn(images), iters=10)
    singles_ms = cuda_ms(
        lambda: [eval_fn(images[i:i + 1]) for i in range(4)], iters=10)
    print(f"phase 4: bf16 DeeplabMulti eval, one batch of 4: launches "
          f"{ {k: v for k, v in batch_counts.items() if v} }; {held}; "
          f"one batch of 4 (kernel 3) {batch_ms:.3f} ms = "
          f"{4e3 / batch_ms:.2f} img/s, the same batch with those convs on "
          f"cuDNN {library_ms:.3f} ms = {4e3 / library_ms:.2f} img/s, four "
          f"single images (cuDNN) {singles_ms:.3f} ms = "
          f"{4e3 / singles_ms:.2f} img/s (CUDA events, 10 rounds, input on "
          f"the card) [{smi}]")
    print(f"phase 4: batched bf16 eval profile: "
          f"{profile_eval(lambda: eval_fn(images))}")


def phase_f32_card_vs_cpu(cpu_model, card_model, phase: int = 5,
                          name: str = "DeeplabMulti", n: int = 2) -> None:
    from adaptsegnet_tpu_torch.eval.evaluator import make_eval_fn
    from adaptsegnet_tpu_torch.ops.resize import upsample_logits

    in_hw, out_hw = (256, 512), (512, 1024)
    images = torch.from_numpy(make_images(n, in_hw, SEED + 2))
    card = make_eval_fn(card_model, out_hw=out_hw)(images.cuda()).cpu()
    cpu = make_eval_fn(cpu_model, out_hw=out_hw)(images)
    with torch.inference_mode():
        preds = cpu_model(images)
        up = upsample_logits(preds[1] if isinstance(preds, tuple) else preds,
                             out_hw, exact=True)
    eq = card == cpu
    agree = eq.float().mean().item()
    top2 = up.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1])[~eq]
    worst = margin.max().item() if margin.numel() else 0.0
    # A flip needs a margin within f32 rounding of the logits' scale: 1e-3 at
    # DeeplabMulti's logits of ~10, 1e-4 of the largest logit beyond that.
    scale = up.abs().max().item()
    tol = max(1e-3, 1e-4 * scale)
    check(agree >= 0.999 and worst < tol,
          f"f32 card vs CPU masks agree {agree:.6f} (need 0.999), largest "
          f"mismatch margin {worst:.3g} (need < {tol:.3g}; largest |logit| "
          f"{scale:.3g})")
    print(f"phase {phase}: f32 {name} eval card vs CPU {n}x{in_hw} -> {out_hw}: agreement "
          f"{agree:.6f}, {int((~eq).sum())} mismatches, largest CPU top-2 "
          f"margin at a mismatch {worst:.3g} (< {tol:.3g}; largest |logit| "
          f"{scale:.3g})")


def phase_cli(cpu_model, phase: int = 6, name: str = "DeeplabMulti") -> None:
    """cli.evaluate --model `name` on a checkpoint of `cpu_model`, then
    cli.iou on its PNGs, on 2 synthetic Cityscapes images."""
    from adaptsegnet_tpu_torch.data import lists
    from adaptsegnet_tpu_torch.utils import pth_interop

    root = os.path.join(WORK, f"cityscapes_{name}")
    list_path = lists.make_synthetic_cityscapes(
        root, "val", n=2, size_wh=EVAL_IN[::-1])
    with open(list_path) as f:
        names = f.read().split()
    gt_dir, labels = lists.make_synthetic_cityscapes_gt(
        root, names, size_wh=EVAL_OUT[::-1])
    devkit = os.path.join(root, "devkit")
    lists.write_devkit(devkit, names, labels)
    ckpt = os.path.join(root, "GTA5_smoke.pth")
    pth_interop.save_torch_state_dict(cpu_model.state_dict(), ckpt)
    pred_dir = os.path.join(root, "result")
    t0 = time.perf_counter()
    for cmd in (
        ["-m", "adaptsegnet_tpu_torch.cli.evaluate", "--model", name,
         "--data-dir", root, "--data-list", list_path, "--restore-from", ckpt,
         "--save", pred_dir],
        ["-m", "adaptsegnet_tpu_torch.cli.iou", "--gt_dir", gt_dir,
         "--pred_dir", pred_dir, "--devkit_dir", devkit, "--single-dir"],
    ):
        proc = subprocess.run([sys.executable, *cmd], cwd=REPO,
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0,
              f"{cmd[1]} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    miou = [ln for ln in proc.stdout.splitlines() if ln.startswith("===> mIoU:")]
    check(len(miou) == 1, "cli.iou printed no '===> mIoU:' line")
    pngs = sorted(os.listdir(pred_dir))
    check(len(pngs) == 4, f"expected 2 masks + 2 color PNGs, got {pngs}")
    print(f"phase {phase}: cli.evaluate --model {name} (f32, {EVAL_IN} -> "
          f"{EVAL_OUT}) + cli.iou on "
          f"2 synthetic images: {miou[0]} ({time.perf_counter() - t0:.1f} s "
          "with process start-up)")


def phase_evaluator(model, smi: str, device_ms: float, distinct: int = 16,
                    short: int = 20, long: int = 120) -> None:
    """Evaluator.run end to end, as the CLI runs it (f32): PNG decode and
    bicubic resize on the host threads, forward and tail on the card, mask
    PNG writes. The images are random-noise 2048x1024 PNGs (Cityscapes'
    size), whose decode costs more than a photo's; `distinct` of them are
    written and hard-linked under `long` names.

    One Evaluator runs a warm-up list of 4 images, then `short` and `long`
    images, host clock. Each run pays the pipeline's fill (the first
    decodes) and drain (the last PNG writes) once, so the difference of
    the two runs over the difference of their lengths is the steady rate,
    and what the short run takes beyond `short` steady images is the fill
    and drain. The host's decode and PNG write, one thread each, are timed
    alone beside it."""
    from adaptsegnet_tpu_torch.data import CityscapesDataset, lists
    from adaptsegnet_tpu_torch.eval.evaluator import Evaluator

    root = os.path.join(WORK, "evaluator")
    t0 = time.perf_counter()
    lists.make_synthetic_cityscapes(
        root, "val", n=distinct, size_wh=EVAL_OUT[::-1], seed=SEED + 4)
    base = os.path.join(root, "leftImg8bit", "val")
    names = [f"synthcity/synthcity_{i:06d}_leftImg8bit.png" for i in range(long)]
    for i in range(distinct, long):
        os.link(os.path.join(base, names[i % distinct]),
                os.path.join(base, names[i]))
    make_s = time.perf_counter() - t0

    def dataset(n):
        path = os.path.join(root, f"val{n}.txt")
        with open(path, "w") as f:
            f.write("\n".join(names[:n]) + "\n")
        return CityscapesDataset(root, path, crop_size=EVAL_IN[::-1])

    ev = Evaluator(model, out_hw=EVAL_OUT, save_dir=os.path.join(root, "out"))
    secs = {}
    for n in (4, short, long):
        t0 = time.perf_counter()
        written = ev.run(dataset(n), batch_size=1, progress_every=1000)
        torch.cuda.synchronize()
        secs[n] = time.perf_counter() - t0
        check(len(written) == n, f"Evaluator wrote {len(written)} of {n} masks")
    steady_ms = (secs[long] - secs[short]) / (long - short) * 1e3
    fill_drain_ms = secs[short] * 1e3 - short * steady_ms

    ds = dataset(8)
    t0 = time.perf_counter()
    items = [ds[i] for i in range(8)]
    decode_ms = (time.perf_counter() - t0) / 8 * 1e3
    mask = ev.eval_fn(torch.from_numpy(items[0][0][None]).cuda())[0].cpu().numpy()
    t0 = time.perf_counter()
    for item in items:
        ev._save_mask(mask, item[-1])
    write_ms = (time.perf_counter() - t0) / 8 * 1e3
    print(f"phase 7: Evaluator.run f32, {EVAL_OUT[::-1]} PNG -> {EVAL_IN} -> "
          f"{EVAL_OUT} masks + PNGs, host clock: {short} images {secs[short]:.3f} "
          f"s, {long} images {secs[long]:.3f} s -> steady {steady_ms:.3f} ms/img "
          f"({1e3 / steady_ms:.2f} img/s), fill + drain {fill_drain_ms:.1f} ms "
          f"per run; forward + tail alone {device_ms:.3f} ms/img (CUDA events); "
          f"host, one thread: decode + resize {decode_ms:.1f} ms/img, mask + "
          f"colour PNG write {write_ms:.1f} ms/img ({distinct} distinct noise "
          f"PNGs made in {make_s:.1f} s) [{smi}]")


def phase_timings(models, results: dict, smi: str) -> dict:
    from adaptsegnet_tpu_torch.eval.evaluator import make_eval_fn
    from adaptsegnet_tpu_torch.ops.kernels import (
        upsample_argmax,
        upsample_argmax_plain,
    )

    image = torch.from_numpy(make_images(1, EVAL_IN, SEED + 3)).cuda()
    for dtype, model in models.items():
        fn = make_eval_fn(model, out_hw=EVAL_OUT, dtype=dtype)
        ms = cuda_ms(lambda: fn(image), iters=20)
        results[f"eval_ms_{dtype}"] = ms
        name = str(dtype).removeprefix("torch.")
        print(f"phase 7: eval {name} bs1 {EVAL_IN} -> {EVAL_OUT}, input on "
              f"the card: {ms:.3f} ms/img, {1000.0 / ms:.2f} img/s [{smi}]")
        print(f"phase 7: eval {name} profile: {profile_eval(lambda: fn(image))}")

    logits = results["eval_logits"]  # (1, 64, 128, 19) bf16 from phase 4
    kernel_ms = cuda_ms(lambda: upsample_argmax(logits, EVAL_OUT), iters=200)
    plain_ms = cuda_ms(lambda: upsample_argmax_plain(logits, EVAL_OUT), iters=20)
    library_ms = cuda_ms(lambda: F.interpolate(
        logits.permute(0, 3, 1, 2).float(), EVAL_OUT, mode="bilinear",
        align_corners=True).argmax(1).to(torch.uint8), iters=20)
    ops, bytes_moved = upsample_argmax_work(logits, EVAL_OUT)
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    ops_ms = ops / PEAK_F32 * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    per_image = results["launches"]["upsample_argmax"] / 4
    print(f"phase 7: upsample_argmax {tuple(logits.shape)} bf16 -> {EVAL_OUT}: "
          f"kernel {kernel_ms * 1e3:.2f} us, {per_image:g} launch/img, bound "
          f"{bound_ms * 1e3:.2f} us ({ops:.3g} ops -> {ops_ms * 1e3:.2f} us, "
          f"{bytes_moved / 1e6:.2f} MB -> {bytes_ms * 1e3:.2f} us), plain tail "
          f"{plain_ms * 1e3:.2f} us, F.interpolate+argmax {library_ms * 1e3:.2f} us "
          f"[{smi}]")
    return {
        "name": "upsample_argmax",
        "route": "cuda",
        "source": "adaptsegnet_tpu_torch/csrc/upsample_argmax.cu",
        "replaces": "adaptsegnet_tpu/ops/pallas/upsample_argmax.py:80",
        "launches": None,  # filled at the end, over every driven path
        "max_abs_err": results["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }


# ------------------------------------------------------------ train slice

TRAIN_IN = (512, 1024)
PARITY_IN = (128, 256)
PARITY_WARPER_LAYERS = 7  # 2^7 divides 128 and 256: the deepest that fits
# H100 SXM data sheet: dense bf16 tensor cores, f32 on CUDA cores, HBM.
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# Launches of each kernel direction in one step at iter_size 1 (directions
# not listed: 0).
# multi-level: kernel 2 on the 26 dilated 3x3s (layer3 23, layer4 3) per
# domain; kernel 5 on conv2..4 of the 6 D applications (2 in the G loss, 4
# in the D losses), wgrad only in the D losses; kernel 4 on conv1 of the 6
# applications, dgrad only in the G loss (the D losses detach the maps).
# source-only with the Warper: kernel 2 on one domain; kernel 5 forward on
# the 7 bf16 Warper encoder convs down1..out (no grad: the Warper runs under
# no_grad); kernel 6 forward and dx once each, its d-flow never (the flow is
# a constant of the loss).
STEP_LAUNCHES = {
    "multi-level": {
        "conv3x3_dil_fwd": 52, "conv3x3_dil_dgrad": 52,
        "conv4x4_s2_fwd": 18, "conv4x4_s2_dgrad": 18, "conv4x4_s2_wgrad": 12,
        "conv4x4_patch_fwd": 6, "conv4x4_patch_dgrad": 2,
        "conv4x4_patch_wgrad": 4,
    },
    "source-only": {
        "conv3x3_dil_fwd": 26, "conv3x3_dil_dgrad": 26, "conv4x4_s2_fwd": 7,
        "upsample_warp_fwd": 1, "upsample_warp_dx": 1,
    },
    # f32 runs kernels 2 and 5 nowhere (bf16 only); kernel 6 takes both dtypes
    "source-only/f32": {"upsample_warp_fwd": 1, "upsample_warp_dx": 1},
}
REPLACES = {
    "conv3x3_dil_fwd": "adaptsegnet_tpu/ops/pallas/conv3x3_dil.py:204",
    "conv3x3_dil_dgrad": "adaptsegnet_tpu/ops/pallas/conv3x3_dil.py:204",
    "conv3x3_dil_batched_fwd": "adaptsegnet_tpu/ops/pallas/conv3x3_dil.py:161",
    "conv4x4_s2_fwd": "adaptsegnet_tpu/ops/pallas/conv4x4_s2.py:132",
    "conv4x4_s2_dgrad": "adaptsegnet_tpu/ops/pallas/conv4x4_s2.py:299",
    "conv4x4_s2_wgrad": "adaptsegnet_tpu/ops/pallas/conv4x4_s2.py:194",
    "conv4x4_patch_fwd": "adaptsegnet_tpu/ops/pallas/conv4x4_patch.py:184",
    "conv4x4_patch_dgrad": "adaptsegnet_tpu/ops/pallas/conv4x4_patch.py:295",
    "conv4x4_patch_wgrad": "adaptsegnet_tpu/ops/pallas/conv4x4_patch.py:233",
    "upsample_warp_fwd": "adaptsegnet_tpu/ops/pallas/upsample_warp.py:432",
    "upsample_warp_dx": "adaptsegnet_tpu/ops/pallas/upsample_warp.py:467",
    "upsample_warp_dflow": "adaptsegnet_tpu/ops/pallas/upsample_warp.py:507",
}
# Kernel 3 on the batched bf16 eval path (4 images, 512x1024): (label, N,
# (H, W), C, d, nb). BATCHED_EXTRA is checked and timed too but stays out of
# the kernels line: the Oracle's 65x129 map (no multiple of the 128-row tile,
# so every group's last tile is masked) and N = 8 with nb chosen and forced.
BATCHED_MAIN = (("layer2 N4", 4, (64, 128), 128, 1, None),
                ("layer3 N4", 4, (64, 128), 256, 2, None),
                ("layer4 N4", 4, (64, 128), 512, 4, None))
BATCHED_EXTRA = (("Oracle layer3 65x129 N2", 2, (65, 129), 256, 2, None),
                 ("layer3 N8", 8, (64, 128), 256, 2, None),
                 ("layer3 N8 nb2", 8, (64, 128), 256, 2, 2))
# Directions that no main path runs: the flow is a constant of the loss in
# every train mode (the Warper runs under no_grad), so kernel 6's d-flow is
# held against its plain version in phase 8 only.
OFF_PATH = {"upsample_warp_dflow"}
# csrc/<stem>.cu of a direction whose name is not <stem>_<direction>.
SOURCES = {"conv3x3_dil_batched_fwd": "conv3x3_dil"}
# The Warper encoder's kernel-5 convs at 512x1024: (input H, W, Cin, Cout).
WARPER_ENCODER = (("down1", (256, 512, 64, 128)), ("down2", (128, 256, 128, 256)),
                  ("down3", (64, 128, 256, 512)), ("down4", (32, 64, 512, 512)),
                  ("down5", (16, 32, 512, 512)), ("down6", (8, 16, 512, 512)),
                  ("out", (4, 8, 512, 512)))


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            "cuda", torch.bfloat16)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def window_share(n, hw, iy, ix) -> float:
    """The share of output pixels whose 3x3 lo-res cells lie in their
    tile's window (the rest take kernel 6's device-memory path), from the
    checkout's tile_plan; nan where the checkout has none."""
    from adaptsegnet_tpu_torch.ops.kernels import upsample_warp as k6

    plan = getattr(k6, "tile_plan", None)
    if plan is None:
        return float("nan")
    out_hw = tuple(iy.shape[1:])
    th, tw, m, wh, ww = plan(n, hw, out_hw, 19)
    sy, sx = k6.scales(hw, out_hw)
    rows = torch.arange(out_hw[0], device=iy.device)
    cols = torch.arange(out_hw[1], device=iy.device)
    y0 = torch.floor((rows // th * th).float() * sy).long() - m
    x0 = torch.floor((cols // tw * tw).float() * sx).long() - m
    by = torch.floor(torch.floor(iy) * sy).long() - y0.view(1, -1, 1)
    bx = torch.floor(torch.floor(ix) * sx).long() - x0.view(1, 1, -1)
    inside = (by >= 0) & (by <= wh - 3) & (bx >= 0) & (bx <= ww - 3)
    return inside.float().mean().item()


def warp_directions(cases, suffix, label, x, g, iy, ix) -> None:
    """Kernel 6's three directions on x (N, h, w, C) and planar g at the
    positions (iy, ix), under '<name><suffix>'. Library: F.interpolate
    (align_corners=True) then F.grid_sample (align_corners=True) in x's
    dtype, forward; for dx and d-flow its autograd backward alone (a
    retained graph, gradient with respect to x, or to the grid; the grid is
    cast to the input's dtype, as grid_sample requires). Operations counted
    per output pixel and channel: 9 fmas (fwd, dx), 9 fmas + the two 9-term
    sums (d-flow); f32 on CUDA cores. Bytes: x, g or the output, and the
    coordinates, each once."""
    from adaptsegnet_tpu_torch.ops.kernels import upsample_warp as k6

    n, h, w, c = x.shape
    out_hw = tuple(iy.shape[1:])
    p = out_hw[0] * out_hw[1]
    es = x.element_size()
    f32 = x.dtype == torch.float32
    grid = torch.stack([ix / (out_hw[1] - 1) * 2 - 1,
                        iy / (out_hw[0] - 1) * 2 - 1], -1)
    xn = x.permute(0, 3, 1, 2).contiguous()

    def library(xin, gin):
        up = F.interpolate(xin, out_hw, mode="bilinear", align_corners=True)
        return F.grid_sample(up, gin.to(xin.dtype), mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    label += f" ({window_share(n, (h, w), iy, ix):.4%} of pixels in their window)"
    xr = xn.detach().requires_grad_(True)
    lib_dx_out = library(xr, grid)
    gr = grid.detach().requires_grad_(True)
    lib_df_out = library(xn, gr)
    coords, xb, gb = 8 * n * p, x.numel() * es, g.numel() * es
    fma = 2 * 9 * n * p * c
    cases.setdefault("upsample_warp_fwd" + suffix, []).append((
        label, lambda: k6.upsample_warp_fwd(x, iy, ix),
        lambda: k6.upsample_warp_fwd_plain(x, iy, ix),
        lambda: library(xn, grid), fma, xb + coords + gb, f32))
    cases.setdefault("upsample_warp_dx" + suffix, []).append((
        label, lambda: k6.upsample_warp_dx(g, iy, ix, (h, w)),
        lambda: k6.upsample_warp_dx_plain(g, iy, ix, (h, w)),
        lambda: torch.autograd.grad(lib_dx_out, xr, g, retain_graph=True),
        fma, gb + coords + xb, f32))
    cases.setdefault("upsample_warp_dflow" + suffix, []).append((
        label, lambda: torch.cat(k6.upsample_warp_dflow(x, g, iy, ix)),
        lambda: torch.cat(k6.upsample_warp_dflow_plain(x, g, iy, ix)),
        lambda: torch.autograd.grad(lib_df_out, gr, g, retain_graph=True),
        fma + 2 * 2 * 9 * n * p, xb + gb + 2 * coords, True))


# Kernel 6 off the main path, checked and timed but not in the kernels
# line: a raw flow drawn N(0, 0.5) i.i.d. per pixel ('/wide': tanh moves
# most pixels more than the plan's margin off the identity grid, so they
# take the device-memory path), and an edge shape ('/edge': (2, 33, 65, 19)
# -> 257x519, whose tiles are masked at the right and bottom and whose W is
# no multiple of 8, so runs load and store by element) on a smooth flow of
# N(0, 0.05) with clamped corners.
WARP_EDGE = (2, (33, 65), (257, 519))


def _positions(flow, out_hw):
    from adaptsegnet_tpu_torch.ops.upsample_warp import coords_from_flow

    iy, ix = coords_from_flow(flow, out_hw)
    return iy.contiguous(), ix.contiguous()


def warper_positions():
    """The sample positions the main path gives kernel 6 at the train
    geometry: the flow of an 8-layer bf16 Warper at init on a preprocessed
    image (|flow| < ~0.1; its last layer works at full resolution, so
    neighbouring pixels move by a fraction of a cell each), with 64 pixels
    clamped at each corner and 64 at each exact boundary (iy = H-1,
    ix = 0)."""
    from adaptsegnet_tpu_torch.models import Warper

    warper = Warper(dtype=torch.bfloat16, device="cuda",
                    generator=torch.Generator().manual_seed(SEED + 3))
    with torch.no_grad():
        flow = warper(torch.from_numpy(make_images(1, TRAIN_IN, SEED + 50))
                      .cuda())[0].float()
    del warper
    flow[:, :, 0, :64] = 8.0    # clamped at the bottom / right edges
    flow[:, :, 1, :64] = -8.0   # clamped at the top / left edges
    iy, ix = _positions(flow, TRAIN_IN)
    iy[:, 2, :64] = TRAIN_IN[0] - 1.0
    ix[:, 3, :64] = 0.0
    return iy, ix


def warp_cases(rng, cases):
    """Kernel 6 in its three directions at the train geometry, bf16 (the
    main path's, under the names of REPLACES) and f32 (under '<name>/f32',
    checked and printed, not in the kernels line), at `warper_positions`.
    Then the '/wide' and '/edge' cases above, bf16."""
    def draw(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dtype)

    n, (h, w), c, (oh, ow) = 1, (64, 128), 19, TRAIN_IN
    iy, ix = warper_positions()
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "/f32")):
        warp_directions(cases, suffix, "512x1024", draw((n, h, w, c), dtype),
                        draw((n, c, oh, ow), dtype), iy, ix)
    wide = _positions(draw((n, 2, oh, ow), torch.float32) * 0.5, TRAIN_IN)
    warp_directions(cases, "/wide", "512x1024 flow N(0, 0.5)",
                    draw((n, h, w, c), torch.bfloat16),
                    draw((n, c, oh, ow), torch.bfloat16), *wide)
    en, ehw, eout = WARP_EDGE
    flow = draw((en, 2) + eout, torch.float32) * 0.05
    flow[:, :, 0, :8] = 8.0
    flow[:, :, 1, :8] = -8.0
    warp_directions(cases, "/edge", f"({en}, {ehw[0]}, {ehw[1]}, {c}) -> "
                    f"{eout[0]}x{eout[1]}", draw((en,) + ehw + (c,), torch.bfloat16),
                    draw((en, c) + eout, torch.bfloat16), *_positions(flow, eout))


def spread_cotangents(rng, n, c, out_hw):
    """Two planar cotangents (N, C, H, W) f32 whose values spread by 1e4 and
    more within each 16 x 256 tile of kernel 6's dx: N(0, 1) with one
    (pixel, channel) at +-1e4 in every 16 x 256 block of pixels, and the
    cotangent of a mean cross-entropy loss on logits N(0, 4^2) with 10 %
    of the pixels ignored (the softmax of the classes far below the top
    spans many decades)."""
    oh, ow = out_hw
    g = rng.standard_normal((n, c, oh, ow)).astype(np.float32)
    for b in range(n):
        for py in range(0, oh, 16):
            for px in range(0, ow, 256):
                g[b, rng.integers(c), rng.integers(py, min(py + 16, oh)),
                  rng.integers(px, min(px + 256, ow))] = 1e4 * rng.choice([-1, 1])
    z = torch.from_numpy(rng.standard_normal((n, c, oh, ow)).astype(np.float32) * 4)
    label = torch.from_numpy(rng.integers(0, c, (n, oh, ow)))
    valid = torch.from_numpy(rng.random((n, oh, ow)) >= 0.1)
    ce = torch.softmax(z.cuda(), 1) - F.one_hot(label.cuda(), c).permute(0, 3, 1, 2)
    ce = ce * valid.cuda()[:, None] / valid.sum().item()
    return {"N(0, 1) + 1e4 per tile": torch.from_numpy(g).cuda(),
            "cross-entropy": ce.float().contiguous()}


def check_dx_per_cell(rng, iy, ix, hw, c) -> None:
    """Kernel 6's dx against its plain version cell by cell, each by its own
    magnitude, on spread_cotangents at the positions (iy, ix), f32 and bf16.
    Per cell, with S the sum of the magnitudes of its products (the plain dx
    of |g|) and k the count of pixels that reach it: the kernel is within
    2^-24 S of the exact sum before its own rounding, and the plain
    version's f32 products and sum within k 2^-24 S; each rounds once to the
    output's dtype (u = 2^-24 or 2^-8). So they differ by at most
    (k + 1) 2^-24 S + 2 u (|plain| + (k + 1) 2^-24 S). Prints the largest error's share
    of that bound and the kernel's device time."""
    from adaptsegnet_tpu_torch.ops.kernels import upsample_warp as k6

    n, (h, w) = iy.shape[0], hw
    # k: the pixels whose 3x3 taps reach each cell, from the plain version's taps
    ty, vy = k6._axis_taps(iy.reshape(n, -1), k6.scales(hw, iy.shape[1:])[0], h)
    tx, vx = k6._axis_taps(ix.reshape(n, -1), k6.scales(hw, iy.shape[1:])[1], w)
    cells = (ty.unsqueeze(-1) * w + tx.unsqueeze(-2)).reshape(n, -1)
    reach = ((vy.unsqueeze(-1) * vx.unsqueeze(-2)) != 0).reshape(n, -1).float()
    k = torch.zeros(n, h * w, device=iy.device).scatter_add_(1, cells, reach)
    k = k.reshape(n, h, w, 1)
    for name, g32 in spread_cotangents(rng, n, c, tuple(iy.shape[1:])).items():
        for dtype, u in ((torch.float32, 2.0 ** -24), (torch.bfloat16, 2.0 ** -8)):
            g = g32.to(dtype)
            got = k6.upsample_warp_dx(g, iy, ix, hw).float()
            plain = k6.upsample_warp_dx_plain(g, iy, ix, hw).float()
            mag = k6.upsample_warp_dx_plain(g.float().abs(), iy, ix, hw)
            spread = (k + 1) * 2.0 ** -24 * mag
            bound = 1.01 * (spread + 2 * u * (plain.abs() + spread))
            err = (got - plain).abs()
            share = (err / bound.clamp_min(1e-38)).max().item()
            check(bool(torch.isfinite(got).all()) and bool((err <= bound).all()),
                  f"upsample_warp_dx {dtype} on the {name} cotangent: largest "
                  f"error {share:.3g} of its cell's bound")
            own_us = device_us(lambda: k6.upsample_warp_dx(g, iy, ix, hw))[0]
            print(f"phase 8: upsample_warp_dx {dtype} on the {name} cotangent "
                  f"(largest |g| {g.float().abs().max().item():.3g}): every cell "
                  f"within its bound, largest error {share:.3g} of it; device "
                  f"{own_us:.1f} us")


def kernel_cases(rng):
    """Every direction of kernels 2, 5, 4 and 6 at the train steps' shapes:
    {name: [(label, kernel fn, plain fn, library fn, flops, bytes, f32_out)]}.
    Each fn takes no argument; inputs are drawn here from `rng`."""
    from torch.nn.grad import conv2d_input, conv2d_weight

    from adaptsegnet_tpu_torch.ops.kernels import conv3x3_dil as k2
    from adaptsegnet_tpu_torch.ops.kernels import conv4x4_patch as k4
    from adaptsegnet_tpu_torch.ops.kernels import conv4x4_s2 as k5

    def tile(m, cout):  # the plan's tile, where the checkout has one
        plan = getattr(k2, "tile_plan", None)
        return f" tile {'x'.join(map(str, plan(m, cout)))}" if plan else ""

    def splits(m, rows, cout):
        plan = getattr(k5, "wgrad_plan", None)
        return " splits {} x {} px".format(*plan(m, rows, cout)) if plan else ""

    def k4_splits(n, h, wd):
        plan = getattr(k4, "wgrad_plan", None)
        return (" splits {} x {} segments of {} px".format(
            *plan(n, h, wd), k4.WGRAD_PX) if plan else "")

    cl = torch.channels_last
    cases = {name: [] for name in REPLACES}
    cases["conv3x3_dil_batched_fwd/extra"] = []
    for key, table in (("conv3x3_dil_batched_fwd", BATCHED_MAIN),
                       ("conv3x3_dil_batched_fwd/extra", BATCHED_EXTRA)):
        for label, n, (h, wd), c, d, nb in table:
            x = _bf16(rng, (n, h, wd, c))
            w = _bf16(rng, (c, c, 3, 3), 0.02)
            cases[key].append((
                label + tile(n * h * wd, c),
                lambda x=x, w=w, d=d, nb=nb: k2.conv3x3_dil_batched_fwd(x, w, d, nb),
                lambda x=x, w=w, d=d: k2.conv3x3_dil_plain(x, w, d),
                lambda x=x, w=w.contiguous(memory_format=cl), d=d: F.conv2d(
                    _nchw(x), w, None, 1, d, d),
                2 * x.numel() * 9 * c, 2 * (2 * x.numel() + w.numel()), False))
    for label, c, d in (("layer3", 256, 2), ("layer4", 512, 4)):
        x = _bf16(rng, (1, 64, 128, c))
        dy = _bf16(rng, (1, 64, 128, c))
        w = _bf16(rng, (c, c, 3, 3), 0.02)
        flops = 2 * x.numel() * 9 * c
        nbytes = 2 * (2 * x.numel() + w.numel())
        wcl = w.contiguous(memory_format=cl)
        label += tile(x.numel() // c, c)
        cases["conv3x3_dil_fwd"].append((
            label, lambda x=x, w=w, d=d: k2.conv3x3_dil_fwd(x, w, d),
            lambda x=x, w=w, d=d: k2.conv3x3_dil_plain(x, w, d),
            lambda x=x, w=wcl, d=d: F.conv2d(_nchw(x), w, None, 1, d, d),
            flops, nbytes, False))
        cases["conv3x3_dil_dgrad"].append((
            label, lambda dy=dy, w=w, d=d: k2.conv3x3_dil_dgrad(dy, w, d),
            lambda dy=dy, w=w, d=d: k2.conv3x3_dil_plain(
                dy, k2.flip_weights(w), d),
            lambda dy=dy, w=wcl, d=d, s=(1, c, 64, 128): conv2d_input(
                s, w, _nchw(dy), 1, d, d),
            flops, nbytes, False))
    for label, (h, wd, cin, cout) in (("conv2", (256, 512, 64, 128)),
                                      ("conv3", (128, 256, 128, 256)),
                                      ("conv4", (64, 128, 256, 512))):
        x = _bf16(rng, (1, h, wd, cin))
        dy = _bf16(rng, (1, h // 2, wd // 2, cout))
        w = _bf16(rng, (cout, cin, 4, 4), 0.02)
        b = _bf16(rng, (cout,), 0.1)
        flops = 2 * dy.numel() * 16 * cin
        io = 2 * (x.numel() + dy.numel() + w.numel())
        wcl = w.contiguous(memory_format=cl)
        cases["conv4x4_s2_fwd"].append((
            label, lambda x=x, w=w, b=b: k5.conv4x4_s2_fwd(x, w, b),
            lambda x=x, w=w, b=b: k5.conv4x4_s2_fwd_plain(x, w, b),
            lambda x=x, w=wcl, b=b: F.conv2d(_nchw(x), w, b, 2, 1),
            flops, io + 4 * cout, False))
        cases["conv4x4_s2_dgrad"].append((
            label, lambda dy=dy, w=w, hw=(h, wd): k5.conv4x4_s2_dgrad(dy, w, hw),
            lambda dy=dy, w=w, hw=(h, wd): k5.conv4x4_s2_dgrad_plain(dy, w, hw),
            lambda dy=dy, w=wcl, s=(1, cin, h, wd): conv2d_input(
                s, w, _nchw(dy), 2, 1),
            flops, io, False))
        cases["conv4x4_s2_wgrad"].append((
            label + splits(dy.numel() // cout, 16 * cin, cout),
            lambda x=x, dy=dy: k5.conv4x4_s2_wgrad(x, dy),
            lambda x=x, dy=dy: k5.conv4x4_s2_wgrad_plain(x, dy),
            lambda x=x, dy=dy, s=tuple(w.shape): conv2d_weight(
                _nchw(x), s, _nchw(dy), 2, 1),
            flops, io + 2 * w.numel(), True))
    for label, (h, wd, cin, cout) in WARPER_ENCODER:  # no bias (Batch norm)
        x = _bf16(rng, (1, h, wd, cin))
        w = _bf16(rng, (cout, cin, 4, 4), 0.02)
        flops = 2 * (h // 2) * (wd // 2) * cout * 16 * cin
        io = 2 * (x.numel() + (h // 2) * (wd // 2) * cout + w.numel())
        cases["conv4x4_s2_fwd"].append((
            f"warper {label}", lambda x=x, w=w: k5.conv4x4_s2_fwd(x, w, None),
            lambda x=x, w=w: k5.conv4x4_s2_fwd_plain(x, w, None),
            lambda x=x, w=w.contiguous(memory_format=cl): F.conv2d(
                _nchw(x), w, None, 2, 1), flops, io, False))
    n, c, (h, wd) = 1, 19, TRAIN_IN
    x = torch.softmax(_bf16(rng, (n, c, h, wd), 2.0).float(), 1).to(torch.bfloat16)
    dy = _bf16(rng, (n, h // 2, wd // 2, 64))
    w = _bf16(rng, (64, c, 4, 4), 0.05)
    b = _bf16(rng, (64,), 0.1)
    flops = 2 * dy.numel() * 16 * c
    io = 2 * (x.numel() + dy.numel() + w.numel())
    cases["conv4x4_patch_fwd"].append((
        "conv1", lambda: k4.conv4x4_patch_fwd(x, w, b),
        lambda: k4.conv4x4_patch_fwd_plain(x, w, b),
        lambda: F.conv2d(x, w, b, 2, 1), flops, io + 4 * 64, False))
    cases["conv4x4_patch_dgrad"].append((
        "conv1", lambda: k4.conv4x4_patch_dgrad(dy, w, (h, wd)),
        lambda: k4.conv4x4_patch_dgrad_plain(dy, w, (h, wd)),
        lambda: conv2d_input((n, c, h, wd), w, _nchw(dy), 2, 1),
        flops, io, False))
    cases["conv4x4_patch_wgrad"].append((
        "conv1" + k4_splits(n, h, wd), lambda: k4.conv4x4_patch_wgrad(x, dy),
        lambda: k4.conv4x4_patch_wgrad_plain(x, dy),
        lambda: conv2d_weight(x, tuple(w.shape), _nchw(dy), 2, 1),
        flops, io + 2 * w.numel(), True))
    warp_cases(rng, cases)
    return cases


# Kernel 4 off the main path's shape, (N, H, W) of the 19-channel map:
# masked last tiles of a row (Wo = 132: 128 + 4 pixels; the dgrad's
# 64-column tiles at Wo = 70), two images, W not a multiple of 8, and a
# wgrad split of two 64-pixel segments (140 segments).
K4_EDGES = ((1, 16, 24), (1, 8, 264), (2, 6, 140), (1, 10, 26), (1, 280, 16))


def check_kernel4_edges(rng) -> None:
    """Kernel 4's three directions against their plain versions at
    K4_EDGES, with phase 8's tolerances (not timed)."""
    from adaptsegnet_tpu_torch.ops.kernels import conv4x4_patch as k4

    worst = [0.0, 0.0, 0.0]
    for n, h, wd in K4_EDGES:
        x = torch.softmax(_bf16(rng, (n, 19, h, wd), 2.0).float(), 1).to(
            torch.bfloat16)
        dy = _bf16(rng, (n, h // 2, wd // 2, 64))
        w = _bf16(rng, (64, 19, 4, 4), 0.05)
        b = _bf16(rng, (64,), 0.1)
        for d, (got, ref, f32_out) in enumerate((
                (k4.conv4x4_patch_fwd(x, w, b),
                 k4.conv4x4_patch_fwd_plain(x, w, b), False),
                (k4.conv4x4_patch_dgrad(dy, w, (h, wd)),
                 k4.conv4x4_patch_dgrad_plain(dy, w, (h, wd)), False),
                (k4.conv4x4_patch_wgrad(x, dy),
                 k4.conv4x4_patch_wgrad_plain(x, dy), True))):
            torch.cuda.synchronize()
            worst[d] = max(worst[d], compare_outputs(got, ref, f32_out)[1])
    print(f"phase 8: conv4x4_patch at (N, H, W) in {list(K4_EDGES)}: fwd / "
          f"dgrad / wgrad within tolerance, max abs err {worst[0]:.2e} / "
          f"{worst[1]:.2e} / {worst[2]:.2e} of max |plain|")


def compare_outputs(got, ref, f32_out: bool) -> tuple[float, float]:
    """Kernel vs plain version on the same bf16 inputs. Both form exact
    products and sum them in f32 in different orders, so they differ by
    f32 rounding before the output's own rounding. bf16 outputs: within one
    bf16 ulp of the plain value (2^-7 relative) plus 1e-3 of the largest
    magnitude; f32 outputs (wgrad): within 1e-4 of the largest magnitude.
    Returns (max abs error, max abs error / max |plain|)."""
    got, ref = got.float(), ref.float()
    check(got.shape == ref.shape, f"shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    err = (got - ref).abs()
    scale = ref.abs().max().item()
    tol = (1e-4 * scale if f32_out
           else 2.0 ** -7 * ref.abs() + 1e-3 * scale)
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
    worst = err.max().item()
    check(ok, f"kernel vs plain: max abs error {worst:.4g} at scale {scale:.4g}")
    return worst, worst / max(scale, 1e-30)


def device_us(fn, iters: int = 10) -> tuple[float, float, float, float]:
    """Device time of one fn() call from a torch.profiler window over
    `iters` calls after a warm-up: (the hand-written kernels' own, the
    PyTorch kernels it also launches, such as weight relayouts and casts),
    in us per call, then the share of the hand-written kernels' records
    that the profiler kept and the window's CUDA-event time per call in us.
    In a whole chip_smoke run (not with --kernels-only) the profiler drops
    10-60 % of the kernel records of these windows, so each kernel's time
    is the mean over the records kept times its launches per call, which
    are whole: `count / iters` rounded up. The CUDA-event time of `cuda_ms`
    also holds the gaps between launches that the wrapper's host work
    leaves."""
    import math

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    own = torch_side = kept = launched = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.device_time_total <= 0:
            continue
        per_call = math.ceil(e.count / iters)
        us = e.device_time_total / e.count * per_call
        if "at::" in e.key or "Memcpy" in e.key or "Memset" in e.key:
            torch_side += us
        else:
            own += us
            kept += e.count
            launched += per_call * iters
    return (own, torch_side, kept / max(launched, 1),
            start.elapsed_time(end) * 1e3 / iters)


def time_kernel(kern, plain, lib, flops: float, nbytes: float,
                peak: float) -> dict:
    """One kernel call's times: its wrapper's CUDA-event time, the host's
    time to enqueue one call (where it exceeds the device time, the
    CUDA-event time is the host's), the device time of the call's kernels
    from a profiler window, the hand-written ones apart from the PyTorch
    ones (weight relayout, bias cast, a zeroed buffer), with the share of
    records the profiler kept, the window's CUDA-event time and the SM clock
    that nvidia-smi reads right after the window; then the plain version's
    and the library call's times and the bound, the larger of `flops` at
    `peak` and `nbytes` at the HBM rate. Returns those in ms under the
    kernels line's names, and the printed text under 'line'."""
    ms = cuda_ms(kern, iters=20)
    own_us, torch_us, kept, window_us = device_us(kern)
    sm = nvidia_smi("clocks.sm")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        kern()
    host_us = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    plain_ms = cuda_ms(plain, iters=5)
    lib_ms = cuda_ms(lib, iters=20)
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    device = (f"device {own_us:.1f} us ({flops / own_us / 1e6:.1f} "
              f"TFLOP/s, {max(ops_ms, bytes_ms) * 1e5 / own_us:.1f} % "
              f"of the bound; {kept:.0%} of its records kept) + {torch_us:.1f} "
              f"us of PyTorch kernels"
              if own_us > 0 else "device time not measured (the "
              "profiler saw no kernel)")
    device += f"; profiled window {window_us:.1f} us/call, then SM clock {sm}"
    line = (f"kernel {ms * 1e3:.1f} us ({flops / ms / 1e9:.1f} TFLOP/s; host "
            f"enqueue {host_us:.1f} us/call); {device}; plain "
            f"{plain_ms * 1e3:.1f} us, library {lib_ms * 1e3:.1f} us, bound "
            f"{max(ops_ms, bytes_ms) * 1e3:.2f} us ({flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops_ms=ops_ms,
                bytes_ms=bytes_ms, line=line)


def phase_train_kernels(smi: str) -> dict:
    """Each new kernel direction against its plain version at the train
    shapes, then its times (`time_kernel`) beside the plain version's, the
    library call's and its bound. Per direction the numbers are summed over
    the shapes the main path gives it (one call each)."""
    from adaptsegnet_tpu_torch.ops.kernels import KERNELS

    rng = np.random.default_rng(SEED + 10)
    rows = {}
    for name, cases in kernel_cases(rng).items():
        kname = name.split("/")[0]
        peak = PEAK_F32 if kname.startswith("upsample_warp") else PEAK_BF16
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0,
                   bytes_ms=0.0, err=0.0)
        for label, kern, plain, lib, flops, nbytes, f32_out in cases:
            before = KERNELS[kname].launches
            got = kern()
            torch.cuda.synchronize()
            check(KERNELS[kname].launches == before + 1,
                  f"{name} did not count its launch")
            err, rel = compare_outputs(got, plain(), f32_out)
            times = time_kernel(kern, plain, lib, flops, nbytes, peak)
            print(f"phase 8: {name} {label}: max abs err {err:.3g} "
                  f"({rel:.2e} of max |plain|); {times.pop('line')} [{smi}]")
            for k, v in times.items():
                tot[k] += v
            tot["err"] = max(tot["err"], err)
        if name not in REPLACES:
            continue
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "adaptsegnet_tpu_torch/csrc/" + SOURCES.get(
                name, name.rsplit("_", 1)[0]) + ".cu",
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": tot["err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": max(tot["ops_ms"], tot["bytes_ms"]),
            "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
            "library_ms": tot["library_ms"],
        }
    check_kernel4_edges(rng)
    check_dx_per_cell(rng, *warper_positions(), (64, 128), 19)
    return rows


def train_batch(hw, seed, device="cuda"):
    """One seeded synthetic (iter_size 1, bs 1) batch: preprocessed random
    images for both domains, labels uniform over the 19 classes with 10 %
    ignored (255)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 19, (1, 1) + hw)
    labels[rng.random((1, 1) + hw) < 0.1] = 255
    return {
        "images": torch.from_numpy(make_images(1, hw, seed)[None]).to(device),
        "target_images": torch.from_numpy(
            make_images(1, hw, seed + 1)[None]).to(device),
        "labels": torch.from_numpy(labels).to(device),
    }


def train_state(dtype: str, device, hw, mode: str = "multi-level",
                warper_layers: int = 8, **extra):
    """The state and step of one mode: 'multi-level' (no Warper),
    'source-only' or 'single-level' (with the Warper), seed SEED; `extra`
    sets further TrainConfig fields (bn_mode)."""
    from adaptsegnet_tpu_torch.train.build import build_train_state
    from adaptsegnet_tpu_torch.train.config import TrainConfig
    from adaptsegnet_tpu_torch.train.steps import (
        make_adversarial_step,
        make_source_only_step,
    )

    cfg = TrainConfig(source_only=mode == "source-only",
                      level="multi-level" if mode == "multi-level" else "single-level",
                      warper=mode != "multi-level",
                      warper_num_layers=warper_layers,
                      input_size=f"{hw[1]},{hw[0]}", compute_dtype=dtype,
                      restore_from="", random_seed=SEED, **extra)
    state = build_train_state(cfg, torch.device(device))
    if cfg.source_only:
        return state, make_source_only_step(input_hw=hw)
    return state, make_adversarial_step(level=cfg.level, input_hw=hw)


def _bn_stats(warper) -> dict:
    return {k: v.detach().clone() for k, v in warper.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def phase_train(smi: str, results: dict, mode: str = "multi-level",
                dtype: str = "bfloat16", warmup: int = 2, steps: int = 10) -> None:
    """A train step at 512x1024, bs 1, full DeeplabMulti: bf16 multi-level
    with D1/D2 (phase 9, the train slice's main path), or source-only with
    the 8-layer Warper (phase 12, the fork's default mode, bf16 and f32).
    The bf16 runs' launch counts go into the kernels line."""
    from adaptsegnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    phase = 9 if mode == "multi-level" else 12
    expected = STEP_LAUNCHES[mode if dtype == "bfloat16" else f"{mode}/f32"]
    state, step = train_state(dtype, "cuda", TRAIN_IN, mode)
    batches = [train_batch(TRAIN_IN, SEED + 20 + i) for i in range(3)]
    watch = {"G layer6": state.model.layer6.conv2d_list[0].weight,
             "G layer3.0.conv2": state.model.layer3[0].conv2.weight}
    if state.d1 is not None:
        watch["D1 conv1"] = state.d1.conv1.weight
    if state.d2 is not None:
        watch["D2 conv3"] = state.d2.conv3.weight
    before = {k: v.detach().clone() for k, v in watch.items()}
    if state.warper is not None:
        w_weights = {k: v.detach().clone() for k, v in
                     state.warper.named_parameters()}
        w_stats = _bn_stats(state.warper)
    t0 = time.perf_counter()
    first = step(state, batches[0])
    first = {k: float(v) for k, v in first.items()}
    for i in range(1, warmup):
        step(state, batches[i % 3])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(all(np.isfinite(v) for v in first.values()), f"step 0 losses {first}")
    check(abs(first["loss_seg2"] - np.log(19)) < 0.05,
          f"step 0 loss_seg2 {first['loss_seg2']:.4f}, expected ~ln 19")

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps):
        metrics = step(state, batches[i % 3])
    end.record()
    torch.cuda.synchronize()
    counts = launch_counts()
    ms = start.elapsed_time(end) / steps
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    last = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in last.values()), f"losses {last}")
    for name, count in counts.items():
        per_step = expected.get(name, 0)
        check(count == per_step * steps,
              f"{mode} {dtype}: {name} launched {count} times in {steps} "
              f"steps, expected {per_step * steps}")
    if dtype == "bfloat16":
        results["path_launches"][f"train {mode}"] = counts
    results.setdefault("train_ms", {})[f"{mode} {dtype}"] = ms
    moved = {k: (v.detach() - before[k]).abs().max().item() for k, v in watch.items()}
    check(all(m > 0 for m in moved.values()), f"parameters did not move: {moved}")
    warper_note = ""
    if state.warper is not None:
        fixed = all(torch.equal(v, w_weights[k])
                    for k, v in state.warper.named_parameters())
        stats = _bn_stats(state.warper)
        still = [k for k, v in stats.items() if torch.equal(v, w_stats[k])]
        check(fixed, "the Warper's weights moved")
        check(not still, f"Warper BN statistics did not move: {still[:4]}")
        warper_note = (f"; Warper weights unchanged, all {len(stats)} BN "
                       "running statistics moved")
    name = ("multi-level step, full DeeplabMulti + D1/D2" if mode == "multi-level"
            else "source-only Warper step, full DeeplabMulti + Warper (8 layers)")
    print(f"phase {phase}: {dtype} {name} {TRAIN_IN} bs1: {ms:.3f} ms/step (CUDA "
          f"events, {steps} steps after {warmup} warm-up, {warm_s:.1f} s with "
          f"first-call set-up), peak memory {peak_gb:.2f} GiB; step 0 losses "
          f"{json.dumps(first)}; step {warmup + steps - 1} losses "
          f"{json.dumps(last)}; kernel launches in {steps} steps "
          f"{ {k: v for k, v in counts.items() if v} }; largest |delta| of "
          f"watched params {json.dumps(moved)}{warper_note} [{smi}]")
    if dtype == "bfloat16":
        print(f"phase {phase}: train step profile: "
              f"{profile_eval(lambda: step(state, batches[0]), iters=3)}")


def _flat_grads(modules):
    return torch.cat([p.grad.detach().float().flatten().cpu()
                      for m in modules for p in m.parameters()
                      if p.grad is not None])


def cut_depth_(state, blocks: int) -> None:
    """Keep the first `blocks` bottlenecks of every ResNet stage (the
    optimizer keeps the dropped blocks' parameters, which get no gradient)."""
    for li in range(1, 5):
        stage = getattr(state.model, f"layer{li}")
        setattr(state.model, f"layer{li}", stage[:blocks])


def step_parity(mode: str, dtype: str, extra: dict, blocks: int | None = None):
    """One step on the card and on the CPU from the same weights and batch at
    PARITY_IN -> (largest relative loss error, {name: relative L2 error of
    the gradients, of the generator's update and of the Warper's BN
    statistics' update}, card losses, CPU losses, the generator's gradient
    vector on the CPU and on the card). `blocks` cuts every ResNet stage to
    that many bottlenecks."""
    layers = PARITY_WARPER_LAYERS
    cpu, cpu_step = train_state(dtype, "cpu", PARITY_IN, mode, layers, **extra)
    card, card_step = train_state(dtype, "cuda", PARITY_IN, mode, layers, **extra)
    if blocks is not None:
        cut_depth_(cpu, blocks)
        cut_depth_(card, blocks)
    checkpoint_like_bn_(cpu.model, torch.Generator().manual_seed(SEED + 30))
    card.load_state_dict(cpu.state_dict())
    p0 = {k: v.detach().float().cpu().clone()
          for k, v in cpu.model.state_dict().items()}
    s0 = _bn_stats(cpu.warper) if cpu.warper is not None else {}
    batch = train_batch(PARITY_IN, SEED + 40, device="cpu")
    m_cpu = {k: float(v) for k, v in cpu_step(cpu, batch).items()}
    m_card = {k: float(v) for k, v in card_step(
        card, {k: v.cuda() for k, v in batch.items()}).items()}
    loss_err = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-6)
                   for k in m_cpu)
    errs, g_grads = {}, None
    for label, name in (("G", "model"), ("D1", "d1"), ("D2", "d2")):
        if getattr(cpu, name) is None:
            continue
        g_cpu = _flat_grads([getattr(cpu, name)])
        g_card = _flat_grads([getattr(card, name)])
        errs[label] = ((g_card - g_cpu).norm() / g_cpu.norm()).item()
        if label == "G":
            g_grads = (g_cpu, g_card)
    d_cpu = torch.cat([(v.float() - p0[k]).flatten() for k, v in
                       cpu.model.state_dict().items()])
    d_card = torch.cat([(v.float().cpu() - p0[k]).flatten() for k, v in
                        card.model.state_dict().items()])
    errs["G delta"] = ((d_card - d_cpu).norm() / d_cpu.norm()).item()
    if s0:
        w_cpu = torch.cat([(v - s0[k]).flatten()
                           for k, v in _bn_stats(cpu.warper).items()])
        w_card = torch.cat([(v.cpu() - s0[k]).flatten()
                            for k, v in _bn_stats(card.warper).items()])
        errs["Warper BN stats delta"] = (
            (w_card - w_cpu).norm() / w_cpu.norm()).item()
    return loss_err, errs, m_card, m_cpu, g_grads


def phase_train_parity() -> None:
    """One step on the card against the same step on the CPU (plain
    versions) from the same weights and batch, at PARITY_IN: multi-level,
    and source-only and single-level with a Warper of PARITY_WARPER_LAYERS
    (the deepest that 128x256 takes). layer3/4 keep their widths, so kernel
    2 is routed, the D input is big enough for kernels 4 and 5, and the
    Warper's encoder takes kernel 5. BN statistics drawn checkpoint-like
    so that the gradients are not vanishingly small. Tolerances: f32 (TF32
    off) losses within 1e-4 relative and each gradient vector (and the
    Warper's BN statistics' update) within 1e-3 relative L2; bf16 losses
    within 2e-2 relative and gradients within 2e-2 relative L2
    (activations are rounded to bf16 after every op on both sides, in
    different sum orders, through 101 layers).

    Multi-level runs once more with bn_mode='batch' (train-mode BN with
    frozen affine; "G delta" then also holds the running statistics'
    update), one bottleneck per stage at full width. The gradient through
    the batch statistics is ill-conditioned at a batch of one (the
    projection that removes a cotangent's mean and its component along the
    normalised activations cancels most of it), so rounding that leaves the
    frozen mode's generator gradient at ~1e-7 (f32) and ~1e-3 (bf16) shows
    there at ~1e-3 and ~2e-1. So in that mode f32 holds the generator's
    gradient to 2e-2 and everything else as above; bf16 holds everything
    else as above and the card's generator gradient to the noise of the
    dtype: its distance from the CPU's f32 gradient at most twice the
    CPU's own bf16 gradient's distance from it, plus 2e-2."""
    for mode in ("multi-level", "source-only", "single-level"):
        for dtype, loss_tol, grad_tol in (("bfloat16", 2e-2, 2e-2),
                                          ("float32", 1e-4, 1e-3)):
            loss_err, errs, m_card, m_cpu, _ = step_parity(mode, dtype, {})
            check(loss_err <= loss_tol and max(errs.values()) <= grad_tol,
                  f"{mode} {dtype} card vs CPU step: losses {m_card} vs "
                  f"{m_cpu} (rel {loss_err:.3g}, need <= {loss_tol}); relative "
                  f"L2 {errs} (need <= {grad_tol})")
            note = (f", Warper {PARITY_WARPER_LAYERS} layers"
                    if "Warper BN stats delta" in errs else "")
            print(f"phase 10: {dtype} {mode} step card vs CPU {PARITY_IN}{note}: "
                  f"largest relative loss error {loss_err:.3g} (<= {loss_tol}); "
                  f"relative L2 {json.dumps(errs)} (<= {grad_tol}); card losses "
                  f"{json.dumps(m_card)}")
    truth = None  # the CPU's f32 generator gradient
    for dtype, loss_tol, grad_tol in (("float32", 1e-4, 1e-3),
                                      ("bfloat16", 2e-2, 2e-2)):
        loss_err, errs, m_card, m_cpu, (g_cpu, g_card) = step_parity(
            "multi-level", dtype, {"bn_mode": "batch"}, blocks=1)
        others = {k: v for k, v in errs.items() if k != "G"}
        if truth is None:
            truth, g_ok = g_cpu, errs["G"] <= 2e-2
            g_note = f"G {errs['G']:.3g} (<= 2e-2)"
        else:
            far = lambda g: ((g - truth).norm() / truth.norm()).item()
            g_ok = far(g_card) <= 2 * far(g_cpu) + 2e-2
            g_note = (f"G from the CPU's f32 gradient: card {far(g_card):.3g}, "
                      f"CPU {far(g_cpu):.3g} (card <= twice the CPU's + 2e-2)")
        check(loss_err <= loss_tol and max(others.values()) <= grad_tol and g_ok,
              f"multi-level {dtype} bn_mode batch card vs CPU step: losses "
              f"{m_card} vs {m_cpu} (rel {loss_err:.3g}, need <= {loss_tol}); "
              f"relative L2 {errs} (need <= {grad_tol}); {g_note}")
        print(f"phase 10: {dtype} multi-level step card vs CPU {PARITY_IN}, "
              f"bn_mode batch, one bottleneck per stage: largest relative loss "
              f"error {loss_err:.3g} (<= {loss_tol}); relative L2 "
              f"{json.dumps(others)} (<= {grad_tol}); {g_note}; card losses "
              f"{json.dumps(m_card)}")


def phase_train_cli() -> None:
    """cli.train for 3 steps on synthetic GTA5 / Cityscapes at 512x1024, bf16,
    then cli.evaluate on its snapshot: multi-level without the Warper, the
    default mode flags (source-only with the Warper), single-level with
    the Warper (the source flow reused for the target), and the flags
    --bn-mode batch, --optim-dup-quirk, --model DeeplabVGG --no-source-only
    (single-level, the VGG segmenter) and --source Synscapes (a synthetic
    Synscapes tree written here: img/rgb and img/class with Cityscapes raw
    ids)."""
    from adaptsegnet_tpu_torch.data import lists

    root = os.path.join(WORK, "train_cli")
    size = f"{TRAIN_IN[1]},{TRAIN_IN[0]}"
    gta = lists.make_synthetic_gta5(os.path.join(root, "gta5"), n=3,
                                    size_wh=TRAIN_IN[::-1])
    cs = lists.make_synthetic_cityscapes(os.path.join(root, "cs"), "train", n=3,
                                         size_wh=TRAIN_IN[::-1])
    val = lists.make_synthetic_cityscapes(os.path.join(root, "cs"), "val", n=2,
                                          size_wh=TRAIN_IN[::-1])
    syn = os.path.join(root, "synscapes")
    rng = np.random.default_rng(SEED + 60)
    for part in ("rgb", "class"):
        os.makedirs(os.path.join(syn, "img", part))
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, TRAIN_IN + (3,), dtype=np.uint8)).save(
            os.path.join(syn, "img", "rgb", f"{i + 1}.png"))
        Image.fromarray(rng.integers(0, 34, TRAIN_IN, dtype=np.uint8)).save(
            os.path.join(syn, "img", "class", f"{i + 1}.png"))
    gta_flags = ["--data-dir", os.path.dirname(gta), "--data-list", gta]
    common = ["--compute-dtype", "bfloat16", "--input-size", size,
              "--num-steps", "100", "--num-steps-stop", "3", "--restore-from",
              "", "--num-workers", "2"]
    target = ["--data-dir-target", os.path.dirname(cs), "--data-list-target",
              cs, "--input-size-target", size]
    # label: (mode sub-directory, cli.train flags, cli.evaluate --model)
    modes = {
        "multi_level": ("multi_level", ["--no-warper", "--no-source-only",
                                        "--level", "multi-level", *target,
                                        *gta_flags], "DeeplabMulti"),
        # the default mode: source-only with the Warper
        "source_only": ("source_only", gta_flags, "DeeplabMulti"),
        "single_level": ("single_level", ["--no-source-only", "--level",
                                          "single-level", *target, *gta_flags],
                         "DeeplabMulti"),
        "bn_batch": ("source_only", ["--bn-mode", "batch", *gta_flags],
                     "DeeplabMulti"),
        "dup_quirk": ("source_only", ["--optim-dup-quirk", *gta_flags],
                      "DeeplabMulti"),
        "vgg": ("single_level", ["--model", "DeeplabVGG", "--no-source-only",
                                 *target, *gta_flags], "DeeplabVGG"),
        "synscapes": ("source_only", ["--source", "Synscapes", "--data-dir",
                                      syn, "--data-list", ""], "DeeplabMulti"),
    }
    for label, (sub, flags, eval_model) in modes.items():
        snap = os.path.join(root, f"snap_{label}")
        result = os.path.join(root, f"result_{label}")
        t0 = time.perf_counter()
        for cmd in (
            ["-m", "adaptsegnet_tpu_torch.cli.train", *flags, *common,
             "--snapshot-dir", snap],
            ["-m", "adaptsegnet_tpu_torch.cli.evaluate", "--model", eval_model,
             "--data-dir", os.path.dirname(val), "--data-list", val,
             "--restore-from", os.path.join(snap, sub, "GTA5_3.pth"),
             "--save", result],
        ):
            proc = subprocess.run([sys.executable, *cmd], cwd=REPO,
                                  capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0,
                  f"{cmd[1]} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
            if cmd[1].endswith("train"):
                lines = [ln for ln in proc.stdout.splitlines()
                         if ln.startswith("iter")]
        files = sorted(os.listdir(os.path.join(snap, sub)))
        want = ["GTA5_3.pth"] + {"multi_level": ["GTA5_3_D1.pth", "GTA5_3_D2.pth"],
                                 "single_level": ["GTA5_3_D2.pth"]}.get(sub, [])
        check(len(lines) == 3 and all("nan" not in ln and "inf" not in ln
                                      for ln in lines),
              f"cli.train {label}: loss lines {lines}")
        for f in want:
            check(f in files, f"cli.train wrote {files}, no {f}")
        pngs = os.listdir(result)
        check(len(pngs) == 4, f"cli.evaluate wrote {pngs}")
        mode_flags = " ".join(f for f in flags[:4] if not f.startswith(
            (os.sep, "--data"))) or "(default mode flags)"
        print(f"phase 11: cli.train bf16 {label} ({sub}) {mode_flags} "
              f"3 steps {TRAIN_IN} -> {files}; last loss line: "
              f"{lines[-1] if lines else 'none'}; cli.evaluate on GTA5_3.pth -> "
              f"{len(pngs)} PNGs ({time.perf_counter() - t0:.1f} s with process "
              "start-up)")


def he_scale_vgg_(model) -> None:
    """Rescale DeeplabVGG's N(0, 0.01) feature convs to std sqrt(2 / fan_in):
    at the init law the logits of the 15-conv net vanish and every mask would
    be one class."""
    with torch.no_grad():
        for conv in model.features.values():
            fan_in = 9 * conv.weight.shape[1]
            conv.weight.mul_(float(np.sqrt(2.0 / fan_in)) / 0.01)


def phase_model_families(smi: str, results: dict) -> None:
    """Phase 13: the single-head ResNet (Oracle) and the VGG segmenter."""
    from adaptsegnet_tpu_torch.eval.evaluator import make_eval_fn
    from adaptsegnet_tpu_torch.models import DeeplabSingle, DeeplabVGG
    from adaptsegnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(SEED + 70)
    oracle_cpu = DeeplabSingle(device="cpu", generator=g)
    checkpoint_like_bn_(oracle_cpu, g)
    oracle = DeeplabSingle(dtype=torch.bfloat16, device="cuda")
    oracle.load_state_dict(oracle_cpu.state_dict())
    oracle.eval()
    images = torch.from_numpy(make_images(2, EVAL_IN, SEED + 71)).cuda()
    eval_fn = make_eval_fn(oracle, out_hw=EVAL_OUT, dtype=torch.bfloat16)
    reset_launch_counts()
    masks = eval_fn(images)
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {"conv3x3_dil_batched_fwd": BATCHED_EVAL_LAUNCHES,
                "upsample_argmax": 1}
    for name, count in counts.items():
        check(count == expected.get(name, 0),
              f"Oracle batched bf16 eval launched {name} {count} times, "
              f"expected {expected.get(name, 0)}")
    results["path_launches"]["Oracle eval batch of 2"] = counts
    check(masks.dtype == torch.uint8 and tuple(masks.shape) == (2,) + EVAL_OUT,
          f"Oracle masks {masks.dtype} {tuple(masks.shape)}")
    singles = []
    with torch.inference_mode():
        for i in range(2):  # one image at a time: every conv through cuDNN
            singles.append(oracle(images[i:i + 1]).contiguous())
            check(tuple(singles[-1].shape) == (1, 65, 129, 19),
                  f"Oracle logits {tuple(singles[-1].shape)}, expected the "
                  "ceil-mode pool's 65x129 map")
    held = hold_batch_against_singles(oracle, images, masks, singles)
    ms = cuda_ms(lambda: eval_fn(images), iters=10)
    with library_3x3():
        library_ms = cuda_ms(lambda: eval_fn(images), iters=10)
    print(f"phase 13: bf16 DeeplabSingle (Oracle) eval, one batch of 2 "
          f"{EVAL_IN} -> 65x129 logits -> {EVAL_OUT} masks: launches "
          f"{ {k: v for k, v in counts.items() if v} }; {held}; "
          f"{len(torch.unique(masks))} classes present; {ms:.3f} ms/batch = "
          f"{2e3 / ms:.2f} img/s, with those convs on cuDNN {library_ms:.3f} "
          f"ms/batch (CUDA events, 10 rounds) [{smi}]")
    del oracle

    vgg_cpu = DeeplabVGG(device="cpu", generator=g)
    he_scale_vgg_(vgg_cpu)
    vgg = DeeplabVGG(device="cuda")
    vgg.load_state_dict(vgg_cpu.state_dict())
    phase_f32_card_vs_cpu(vgg_cpu.eval(), vgg.eval(), 13, "DeeplabVGG", n=1)
    del vgg
    torch.cuda.empty_cache()
    phase_cli(oracle_cpu, 13, "Oracle")
    phase_cli(vgg_cpu, 13, "DeeplabVGG")

# ------------------------------------------------------ data parallelism

DP_TIMEOUT_S = 600  # each launch of ranks
DP_STEPS = 5  # phase 14 (a): timed steps after 2 warm-up
DP_EVAL_IMAGES = 5  # phase 14 (c): a ragged tail at a global batch of 2
# What kernels 2, 4, 5 and 6 launch in the profiler CLI's multi-level step
# (kernel 4's three kernels, the core's, kernel 5's wgrad; by CUDA name).
PROFILE_KERNELS = ("conv_sm90_kernel", "wgrad_sm90_kernel", "fwd_kernel",
                   "dgrad_kernel", "wgrad_kernel")


def global_batch(hw, seed, n, device="cuda"):
    """A seeded (iter_size 1, n) batch, as train_batch makes one of 1."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 19, (1, n) + hw)
    labels[rng.random((1, n) + hw) < 0.1] = 255
    return {
        "images": torch.from_numpy(make_images(n, hw, seed)[None]).to(device),
        "target_images": torch.from_numpy(
            make_images(n, hw, seed + 1)[None]).to(device),
        "labels": torch.from_numpy(labels).to(device),
    }


def rank_slice(batch):
    """This rank's interleaved part of a global batch."""
    from adaptsegnet_tpu_torch.parallel import group

    r, w = group.rank(), group.world()
    return {k: v[:, r::w].contiguous() for k, v in batch.items()}


def state_on_cpu(state) -> dict:
    return {name: {k: v.detach().float().cpu().clone()
                   for k, v in m.state_dict().items()}
            for name, m in (("model", state.model), ("d1", state.d1),
                            ("d2", state.d2), ("warper", state.warper))
            if m is not None}


def dp_state(dtype, hw, mode, cut: bool = False, **extra):
    """The phase's seeded state and step; `cut`: phase 10's bn_mode='batch'
    case (one bottleneck per stage, checkpoint-like BN statistics)."""
    state, step = train_state(dtype, "cuda", hw, mode, PARITY_WARPER_LAYERS
                              if hw == PARITY_IN else 8, **extra)
    if cut:
        cut_depth_(state, 1)
        checkpoint_like_bn_(state.model, torch.Generator().manual_seed(SEED + 30))
    return state, step


def one_step(state, step, batch) -> dict:
    """The step's metrics, launch counts and resulting state (on the CPU)."""
    from adaptsegnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    metrics = {k: float(v) for k, v in step(state, batch).items()}
    torch.cuda.synchronize()
    return {"metrics": metrics, "counts": launch_counts(),
            "state": state_on_cpu(state)}


def state_items(state) -> dict:
    """Every tensor of a TrainState's state dict (optimizer states
    included), where it lies, by path; and the step."""
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}.{k}", x)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{prefix}.{i}", x)
        elif isinstance(v, torch.Tensor) or prefix == ".step":
            out[prefix] = v
    walk("", state.state_dict())
    return out


def flat_train_state(state) -> dict:
    """state_items, the tensors copied to the CPU."""
    return {k: v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v
            for k, v in state_items(state).items()}


def nccl_resume(state, mode: str) -> tuple[int, float]:
    """The train loop's start over NCCL (train/loop.py::_resume_or_replicate):
    `state` saved as a full-state checkpoint, then loaded into a freshly
    built state through rank 0's byte broadcast. Checks that every tensor
    (optimizer states included) and the step came through exactly; returns
    the checkpoint's size in bytes and the seconds the start took."""
    from adaptsegnet_tpu_torch.train.loop import _resume_or_replicate
    from adaptsegnet_tpu_torch.utils.checkpoint import FullStateCheckpoints

    full = FullStateCheckpoints(os.path.join(WORK, "nccl_resume"))
    full.save(state.step, state)
    size = os.path.getsize(full.path(state.step))
    fresh, _ = dp_state("bfloat16", TRAIN_IN, mode)
    t0 = time.perf_counter()
    resumed = _resume_or_replicate(fresh, full, torch.device("cuda"))
    took = time.perf_counter() - t0
    want, got = flat_train_state(state), flat_train_state(fresh)
    check(resumed and sorted(got) == sorted(want) and all(
        torch.equal(got[k], v) if isinstance(v, torch.Tensor) else got[k] == v
        for k, v in want.items()), f"(a) {mode}: the NCCL resume differs")
    shutil.rmtree(full.directory)
    return size, took


def dp_nccl_rank(steps: int) -> dict:
    """Phase 14 (a), as the one rank of an NCCL group: the bf16
    multi-level and source-only + Warper steps at full width, each one step
    from the seeded state (held against the no-group step), then ms/step
    by CUDA events over `steps` steps after 2 warm-up, and a profiler
    window (device busy per step); after the multi-level steps, the train
    loop's full-state resume through NCCL (`nccl_resume`)."""
    from adaptsegnet_tpu_torch.parallel import group

    check(group.active() and dist_backend() == "nccl", "no NCCL group")
    out = {}
    for mode in ("multi-level", "source-only"):
        state, step = dp_state("bfloat16", TRAIN_IN, mode)
        batch = train_batch(TRAIN_IN, SEED + 50)
        out[mode] = one_step(state, step, batch)
        for _ in range(2):
            step(state, batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            step(state, batch)
        end.record()
        torch.cuda.synchronize()
        out[mode]["ms"] = start.elapsed_time(end) / steps
        out[mode]["profile"] = profile_eval(lambda: step(state, batch), iters=3)
        if mode == "multi-level":
            out[mode]["resume"] = nccl_resume(state, mode)
        del state
        torch.cuda.empty_cache()
    return out


def dist_backend() -> str:
    import torch.distributed as dist

    return dist.get_backend()


def dp_gloo_rank() -> dict:
    """Phase 14 (b), as one of two gloo ranks on card 0: this rank's half
    of a global batch of 2 through the bf16 multi-level and source-only +
    Warper steps at full width, and the f32 multi-level step with
    bn_mode='batch' at phase 10's size and depth. Rank 0 returns the
    states; both return metrics, launch counts and the host time of two
    more steps."""
    from adaptsegnet_tpu_torch.parallel import group

    check(group.world() == 2 and dist_backend() == "gloo", "no gloo pair")
    out = {}
    for key, dtype, hw, mode, extra, seed in DP_GLOO_CASES:
        state, step = dp_state(dtype, hw, mode, **extra)
        batch = rank_slice(global_batch(hw, seed, 2))
        res = one_step(state, step, batch)
        if group.rank():
            del res["state"]
        t0 = time.perf_counter()
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
        res["ms"] = (time.perf_counter() - t0) * 1e3 / 2
        out[key] = res
        del state
        torch.cuda.empty_cache()
    return out


# (key, dtype, input, mode, state extras, batch seed); --batch-size is the
# global batch, which must divide by the ranks
DP_GLOO_CASES = (
    ("multi-level bf16", "bfloat16", TRAIN_IN, "multi-level",
     {"batch_size": 2}, SEED + 60),
    ("source-only bf16", "bfloat16", TRAIN_IN, "source-only",
     {"batch_size": 2}, SEED + 61),
    ("multi-level f32 bn_mode batch", "float32", PARITY_IN, "multi-level",
     {"batch_size": 2, "bn_mode": "batch", "cut": True}, SEED + 62),
)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def compare_steps(got: dict, ref: dict, start: dict) -> dict:
    """{name: relative L2 error} of each module's update (state after the
    step minus `start`) against the reference's, and of the losses."""
    errs = {"losses": max(abs(got["metrics"][k] - v) / max(abs(v), 1e-6)
                          for k, v in ref["metrics"].items())}
    for mod, sd in ref["state"].items():
        keys = [k for k in sd if mod != "warper" or "running" in k]
        d_got = torch.cat([(got["state"][mod][k] - start[mod][k]).flatten()
                           for k in keys])
        d_ref = torch.cat([(sd[k] - start[mod][k]).flatten() for k in keys])
        errs[mod] = _rel_l2(d_got, d_ref)
    return errs


def dp_eval_rank(ckpt: str, root: str, list_path: str, labels: dict,
                 out_dir: str, images: np.ndarray) -> dict:
    """Phase 14 (c), as one of two gloo ranks on card 0: f32
    Evaluator.run_streaming at a global batch of 2 (this rank's interleaved
    images, its PNGs), then the bf16 batched forward of this rank's pair of
    `images` (kernels 3 and 1)."""
    import torch.distributed as dist

    from adaptsegnet_tpu_torch.data import CityscapesDataset
    from adaptsegnet_tpu_torch.eval.evaluator import Evaluator, make_eval_fn
    from adaptsegnet_tpu_torch.models import DeeplabMulti
    from adaptsegnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from adaptsegnet_tpu_torch.parallel import group
    from adaptsegnet_tpu_torch.utils import pth_interop

    check(group.world() == 2 and dist_backend() == "gloo", "no gloo pair")
    sd = pth_interop.load_torch_state_dict(ckpt)
    model = DeeplabMulti(device="cuda")
    pth_interop.load_into(model, sd)
    ds = CityscapesDataset(root, list_path, crop_size=EVAL_IN[::-1])
    ev = Evaluator(model.eval(), out_hw=EVAL_OUT, save_dir=out_dir,
                   mesh=dist.group.WORLD)
    hist = ev.run_streaming(ds, lambda name: labels[name], batch_size=2,
                            num_workers=2)
    del model, ev
    bf16 = DeeplabMulti(dtype=torch.bfloat16, device="cuda")
    pth_interop.load_into(bf16, sd)
    fn = make_eval_fn(bf16.eval(), out_hw=EVAL_OUT, dtype=torch.bfloat16)
    r = group.rank()
    pair = torch.from_numpy(images[2 * r:2 * r + 2]).cuda()
    reset_launch_counts()
    masks = fn(pair)
    torch.cuda.synchronize()
    return {"hist": hist, "masks": masks.cpu(), "counts": launch_counts()}


def phase_data_parallel(smi: str, results: dict) -> None:
    """Phase 14: data parallelism (parallel/group.py) on the one card."""
    from adaptsegnet_tpu_torch.parallel import group

    torch.cuda.empty_cache()
    per_step = STEP_LAUNCHES

    # (a) NCCL with one rank against the no-group step.
    refs, starts = {}, {}
    for mode in ("multi-level", "source-only"):
        state, step = dp_state("bfloat16", TRAIN_IN, mode)
        starts[mode] = state_on_cpu(state)
        refs[mode] = one_step(state, step, train_batch(TRAIN_IN, SEED + 50))
        del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (nccl,) = group.launch(dp_nccl_rank, 1, args=(DP_STEPS,),
                           timeout=DP_TIMEOUT_S)
    launch_s = time.perf_counter() - t0
    for mode, phase in (("multi-level", 9), ("source-only", 12)):
        got, ref = nccl[mode], refs[mode]
        check(got["counts"] == ref["counts"] and all(
            got["counts"].get(k, 0) == v for k, v in per_step[mode].items()),
            f"(a) {mode}: launches {got['counts']} vs no-group {ref['counts']}")
        results["path_launches"][f"train {mode} DP NCCL 1 rank"] = got["counts"]
        check(got["metrics"] == ref["metrics"],
              f"(a) {mode}: losses {got['metrics']} vs {ref['metrics']}")
        unequal = [f"{mod}.{k}" for mod, sd in ref["state"].items()
                   for k, v in sd.items()
                   if not torch.equal(got["state"][mod][k], v)]
        if mode == "multi-level":
            check(not unequal, f"(a) {mode}: not bit for bit: {unequal[:6]}")
            note = "losses and every parameter, buffer and optimizer input bit for bit"
        else:
            errs = compare_steps(got, ref, starts[mode])
            check(errs["losses"] == 0 and max(errs.values()) <= 2e-2 and not [
                k for k in unequal if k.startswith("warper.")],
                f"(a) {mode}: {errs}; unequal {unequal[:6]}")
            note = (f"losses and the Warper bit for bit; {len(unequal)} "
                    f"tensors differ (kernel 6's dx is not bit-reproducible): "
                    f"relative L2 of the updates {json.dumps(errs)} (<= 2e-2)")
        print(f"phase 14: (a) NCCL group of 1 rank, bf16 {mode} {TRAIN_IN} bs1 "
              f"vs the no-group step: {note}; launches/step "
              f"{ {k: v for k, v in got['counts'].items() if v} }; "
              f"{got['ms']:.3f} ms/step (CUDA events, {DP_STEPS} steps after 2 "
              f"warm-up) against phase {phase}'s "
              f"{results['train_ms'][f'{mode} bfloat16']:.3f} ms/step; "
              f"profile (compare phase {phase}'s device busy): "
              f"{got['profile']} [{smi}]")
    size, took = nccl["multi-level"]["resume"]
    print(f"phase 14: (a) full-state resume through NCCL (rank 0's checkpoint "
          f"file broadcast as bytes, {size} B): every tensor, optimizer "
          f"states included, and the step exact; {took:.2f} s")
    print(f"phase 14: (a) launch of 1 NCCL rank, both steps: {launch_s:.1f} s")

    # (b) two gloo ranks sharing card 0 against the 1-process step.
    refs, starts = {}, {}
    for key, dtype, hw, mode, extra, seed in DP_GLOO_CASES:
        state, step = dp_state(dtype, hw, mode, **extra)
        starts[key] = state_on_cpu(state)
        refs[key] = one_step(state, step, global_batch(hw, seed, 2))
        del state
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = group.launch(dp_gloo_rank, 2, backend="gloo", devices=[0, 0],
                         timeout=DP_TIMEOUT_S)
    launch_s = time.perf_counter() - t0
    for key, dtype, hw, mode, extra, seed in DP_GLOO_CASES:
        r0, r1 = ranks[0][key], ranks[1][key]
        check(r0["metrics"] == r1["metrics"],
              f"(b) {key}: the ranks' losses differ")
        errs = compare_steps(r0, refs[key], starts[key])
        f32 = dtype == "float32"
        loss_tol, tol = (1e-4, 1e-3) if f32 else (2e-2, 2e-2)
        check(errs["losses"] <= loss_tol and max(
            v for k, v in errs.items() if k != "losses") <= tol,
            f"(b) {key}: relative errors {errs} (losses <= {loss_tol}, "
            f"updates <= {tol})")
        if not f32:
            for r, res in enumerate((r0, r1)):
                check(all(res["counts"].get(k, 0) == v
                          for k, v in per_step[mode].items()) and sum(
                    res["counts"].values()) == sum(per_step[mode].values()),
                    f"(b) {key}: rank {r} launches {res['counts']}, expected "
                    f"{per_step[mode]} (phases 9 / 12)")
            results["path_launches"][f"train {mode} DP gloo 2 ranks"] = {
                k: r0["counts"][k] + r1["counts"][k] for k in r0["counts"]}
        print(f"phase 14: (b) gloo, 2 ranks both on cuda:0 (NCCL refuses two "
              f"ranks on one card), {key} {hw}, global batch 2 vs the "
              f"1-process step on it: relative errors {json.dumps(errs)} "
              f"(losses <= {loss_tol}, updates <= {tol}); launches/step per "
              f"rank {[{k: v for k, v in r['counts'].items() if v} for r in (r0, r1)]}; "
              f"host ms/step {r0['ms']:.1f} / {r1['ms']:.1f} (not a "
              f"data-parallel throughput: both ranks share the card and gloo "
              f"goes through the host) [{smi}]")
    print(f"phase 14: (b) launch of 2 gloo ranks, three steps: {launch_s:.1f} s")

    # (c) data-parallel eval on two gloo ranks against one process.
    from adaptsegnet_tpu_torch.data import CityscapesDataset, lists
    from adaptsegnet_tpu_torch.eval.evaluator import Evaluator, make_eval_fn
    from adaptsegnet_tpu_torch.models import DeeplabMulti
    from adaptsegnet_tpu_torch.utils import pth_interop

    root = os.path.join(WORK, "dp_eval")
    list_path = lists.make_synthetic_cityscapes(
        root, "val", n=DP_EVAL_IMAGES, size_wh=EVAL_IN[::-1], seed=SEED + 80)
    g = torch.Generator().manual_seed(SEED + 81)
    cpu = DeeplabMulti(device="cpu", generator=g)
    checkpoint_like_bn_(cpu, g)
    ckpt = os.path.join(root, "m.pth")
    pth_interop.save_torch_state_dict(cpu.state_dict(), ckpt)
    ds = CityscapesDataset(root, list_path, crop_size=EVAL_IN[::-1])
    rng = np.random.default_rng(SEED + 82)
    labels = {}
    for i in range(DP_EVAL_IMAGES):
        label = rng.integers(0, 19, EVAL_OUT).astype(np.uint8)
        label[rng.random(EVAL_OUT) < 0.2] = 255
        labels[ds[i][-1]] = label
    images = make_images(4, EVAL_IN, SEED + 83)
    model = DeeplabMulti(device="cuda")
    model.load_state_dict(cpu.state_dict())
    one_dir, two_dir = os.path.join(root, "one"), os.path.join(root, "two")
    hist = Evaluator(model.eval(), out_hw=EVAL_OUT, save_dir=one_dir
                     ).run_streaming(ds, lambda n: labels[n], batch_size=1)
    bf16 = DeeplabMulti(dtype=torch.bfloat16, device="cuda")
    bf16.load_state_dict(cpu.state_dict())
    fn = make_eval_fn(bf16.eval(), out_hw=EVAL_OUT, dtype=torch.bfloat16)
    pairs = [fn(torch.from_numpy(images[i:i + 2]).cuda()).cpu() for i in (0, 2)]
    del model, bf16, cpu
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = group.launch(dp_eval_rank, 2, backend="gloo", devices=[0, 0],
                         args=(ckpt, root, list_path, labels, two_dir, images),
                         timeout=DP_TIMEOUT_S)
    launch_s = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        check(np.array_equal(res["hist"], hist),
              f"(c) rank {r}: the histogram differs from the 1-process one")
        check(torch.equal(res["masks"], pairs[r]),
              f"(c) rank {r}: bf16 batched masks differ from the 1-process ones")
        check(res["counts"].get("conv3x3_dil_batched_fwd") == BATCHED_EVAL_LAUNCHES
              and res["counts"].get("upsample_argmax") == 1,
              f"(c) rank {r}: launches {res['counts']}")
    results["path_launches"]["eval bf16 batch of 2 DP gloo 2 ranks"] = {
        k: ranks[0]["counts"][k] + ranks[1]["counts"][k] for k in ranks[0]["counts"]}
    names = sorted(os.listdir(one_dir))
    check(sorted(os.listdir(two_dir)) == names and len(names) == 2 * DP_EVAL_IMAGES,
          f"(c) PNGs: {sorted(os.listdir(two_dir))} vs {names}")
    for name in names:
        check(np.array_equal(np.array(Image.open(os.path.join(two_dir, name))),
                             np.array(Image.open(os.path.join(one_dir, name)))),
              f"(c) {name} differs from the 1-process PNG")
    print(f"phase 14: (c) gloo, 2 ranks on cuda:0: f32 Evaluator.run_streaming "
          f"of {DP_EVAL_IMAGES} images {EVAL_IN} -> {EVAL_OUT} at a global "
          f"batch of 2 (local 1, ragged tail): histogram ({int(hist.sum())} "
          f"valid pixels, 20 % ignored) and all {len(names)} PNGs equal to the "
          f"1-process run at batch 1; bf16 batched forward of each rank's pair "
          f"(kernel 3 x{BATCHED_EVAL_LAUNCHES}, kernel 1 x1 per rank): masks "
          f"equal to the 1-process forward of the same pairs; launch "
          f"{launch_s:.1f} s")

    # (d) the profiler CLI: the hand-written kernels by CUDA name, and the
    # wrappers' launches over the traced steps.
    iters = 3
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "adaptsegnet_tpu_torch.cli.profile_step",
         "--iters", str(iters), "--top", "400",
         "--trace-dir", os.path.join(WORK, "profile_step")],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0,
          f"cli.profile_step exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "profile_step.txt"), "w") as f:
        f.write(proc.stdout)
    lines = proc.stdout.splitlines()
    marker = f"kernel wrapper launches over the {iters} traced steps: "
    counts = [json.loads(ln[len(marker):]) for ln in lines
              if ln.startswith(marker)]
    check(len(counts) == 1, "cli.profile_step printed no launch counts")
    expected = {k: iters * v for k, v in per_step["multi-level"].items()}
    check(counts[0] == expected,
          f"(d) launches over the trace {counts[0]}, expected {expected}")
    start = next(i for i, ln in enumerate(lines) if ln.startswith("op type"))
    table = lines[start + 1:]
    table = table[:table.index("")] if "" in table else table
    types = {ln.split()[0] for ln in table if ln.strip()}
    missing = [k for k in PROFILE_KERNELS if k not in types]
    check(not missing, f"(d) kernels missing from the table: {missing}")
    total = next(ln for ln in lines if ln.startswith("total self time"))
    print(f"phase 14: (d) cli.profile_step --iters {iters} (bf16 multi-level "
          f"{TRAIN_IN}): {total}; table names {list(PROFILE_KERNELS)}; wrapper "
          f"launches over the trace {counts[0]} = {iters} x phase 9's per step; "
          f"top rows: {' | '.join(' '.join(ln.split()[:4]) for ln in table[:6])} "
          f"({time.perf_counter() - t0:.1f} s with process start-up; the "
          f"whole table in _smoke_out/profile_step.txt) [{smi}]")

    # (e) the entry point.
    from adaptsegnet_tpu_torch.entry import entry

    fn, (model, x) = entry()
    p1, p2 = fn(model, x)
    torch.cuda.synchronize()
    check(all(tuple(p.shape) == (1, 32, 64, 19) and p.is_cuda
              and bool(torch.isfinite(p).all()) for p in (p1, p2)),
          f"entry(): {p1.shape} {p2.shape}")
    print(f"phase 14: (e) entry() on {x.device}: DeeplabMulti {tuple(x.shape)} "
          f"-> pred1, pred2 {tuple(p1.shape)}, finite")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------ four cards

MC_CARDS = 4  # --multi-card: one NCCL rank per card
MC_TIMEOUT_S = 300  # each launch of ranks and each CLI run in phase 15
MC_STEPS = 5  # phase 15 (a): timed steps
MC_PROFILE_ITERS = 3  # phase 15 (a): steps in rank 0's profiler window
MC_EVAL_IMAGES = 9  # phase 15 (d): a ragged tail at a global batch of 4
MC_EVAL_REPEATS = 10  # phase 15 (d): timed batched forwards per card
# (key, dtype, input, mode, state extras, batch seed): phase 15 (a), each
# on a global batch of MC_CARDS images, one per rank
MC_CASES = (
    ("multi-level bf16", "bfloat16", TRAIN_IN, "multi-level",
     {"batch_size": MC_CARDS}, SEED + 90),
    ("source-only bf16", "bfloat16", TRAIN_IN, "source-only",
     {"batch_size": MC_CARDS}, SEED + 91),
    ("multi-level f32 bn_mode batch", "float32", PARITY_IN, "multi-level",
     {"batch_size": MC_CARDS, "bn_mode": "batch", "cut": True}, SEED + 92),
)


def launch_cards(fn, *args) -> list:
    """fn(*args) on MC_CARDS NCCL ranks, rank r on card r; each rank's
    result."""
    from adaptsegnet_tpu_torch.parallel import group

    return group.launch(fn, MC_CARDS, args=args, timeout=MC_TIMEOUT_S)


def card_barrier() -> None:
    """Every rank's work so far done, on its card and across the group."""
    import torch.distributed as dist

    t = torch.zeros(1, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()


def unequal_to_rank0(state) -> list[str]:
    """The paths of the TrainState's tensors (parameters, buffers, optimizer
    states) and step that differ from rank 0's: rank 0's are broadcast,
    one collective per dtype, and compared bit for bit."""
    import torch.distributed as dist

    items = state_items(state)
    step = torch.tensor([items.pop(".step")], device="cuda")
    by_dtype: dict = {".step": [(".step", step)]}
    for k, v in items.items():
        by_dtype.setdefault(v.dtype, []).append((k, v.detach()))
    bad = []
    for ts in by_dtype.values():
        flat = torch.cat([v.reshape(-1).cuda() for _, v in ts])
        ref = flat.clone()
        dist.broadcast(ref, src=0)
        offset = 0
        for k, v in ts:
            if not torch.equal(flat[offset:offset + v.numel()],
                               ref[offset:offset + v.numel()]):
                bad.append(k)
            offset += v.numel()
    return bad


def grads_on_cpu(state) -> dict:
    """{module: {parameter: gradient}} of G, D1 and D2 after a step (the
    group's sum in a rank), on the CPU in f32."""
    return {name: {k: p.grad.detach().float().cpu().clone()
                   for k, p in m.named_parameters() if p.grad is not None}
            for name, m in (("model", state.model), ("d1", state.d1),
                            ("d2", state.d2)) if m is not None}


def mc_compare(got: dict, ref: dict, start: dict) -> tuple[dict, dict]:
    """A rank's first step against the one-process step -> ({'losses': the
    largest relative loss error, '<module> grad': relative L2 of the
    module's gradient, '<module>': relative L2 of its update, the state
    after the step minus `start` (the Warper: its running statistics)},
    {discriminator: weights left out of its update}). A discriminator's
    first Adam step moves a weight by lr g / (|g| + eps), about lr sign(g):
    where the one-process gradient lies within the two gradients'
    difference of zero, the summation order picks the sign and the weight
    moves by +-lr, so that weight is left out of the update's error and
    counted (its gradient is not left out)."""
    errs = {"losses": max(abs(got["metrics"][k] - v) / max(abs(v), 1e-6)
                          for k, v in ref["metrics"].items())}
    unsettled = {}
    for mod, sd in ref["state"].items():
        g_got, g_ref = got["grads"].get(mod, {}), ref["grads"].get(mod, {})
        if g_ref:
            errs[f"{mod} grad"] = _rel_l2(
                torch.cat([g_got[k].flatten() for k in g_ref]),
                torch.cat([v.flatten() for v in g_ref.values()]))
        d_got, d_ref, n = [], [], 0
        for k, v in sd.items():
            if mod == "warper" and "running" not in k:
                continue
            a, b = got["state"][mod][k] - start[mod][k], v - start[mod][k]
            if mod in ("d1", "d2") and k in g_ref:
                keep = g_ref[k].abs() > (g_got[k] - g_ref[k]).abs()
                n += int((~keep).sum())
                a, b = a[keep], b[keep]
            d_got.append(a.flatten())
            d_ref.append(b.flatten())
        errs[mod] = _rel_l2(torch.cat(d_got), torch.cat(d_ref))
        if mod in ("d1", "d2"):
            unsettled[mod] = n
    return errs, unsettled


def mc_resume(state, mode: str) -> dict:
    """Phase 15 (b), as one rank: rank 0 saves `state` as a full-state
    checkpoint in a directory of its own, then every rank starts a freshly
    built state through the train loop's resume (rank 0 reads the file and
    broadcasts its bytes; the other ranks' directories stay empty) and
    holds every tensor and the step against its own `state`."""
    from adaptsegnet_tpu_torch.parallel import group
    from adaptsegnet_tpu_torch.train.loop import _resume_or_replicate
    from adaptsegnet_tpu_torch.utils.checkpoint import FullStateCheckpoints

    r = group.rank()
    full = FullStateCheckpoints(os.path.join(WORK, f"mc_resume_rank{r}"))
    size = None
    if r == 0:
        full.save(state.step, state)
        size = os.path.getsize(full.path(state.step))
    fresh, _ = dp_state("bfloat16", TRAIN_IN, mode, batch_size=MC_CARDS)
    card_barrier()
    t0 = time.perf_counter()
    resumed = _resume_or_replicate(fresh, full,
                                   torch.device("cuda", torch.cuda.current_device()))
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    want, got = flat_train_state(state), flat_train_state(fresh)
    differ = sorted(set(want) ^ set(got)) + [
        k for k, v in want.items() if k in got and not (
            torch.equal(got[k], v) if isinstance(v, torch.Tensor)
            else got[k] == v)]
    shutil.rmtree(full.directory)
    return {"resumed": resumed, "differ": differ, "bytes": size, "s": took,
            "step": fresh.step,
            "device": str(fresh.model.layer6.conv2d_list[0].weight.device)}


def mc_train_rank() -> dict:
    """Phase 15 (a) and (b), as one of MC_CARDS NCCL ranks: each case of
    MC_CASES from the seeded state on this rank's image of three global
    batches; the first step's metrics, launches and (rank 0) state, and
    after three steps the tensors that differ from rank 0's. The bf16 cases
    then time MC_STEPS steps by CUDA events (launches and peak memory over
    them), and rank 0 profiles MC_PROFILE_ITERS more; after the multi-level
    steps, the resume across cards (`mc_resume`)."""
    from adaptsegnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from adaptsegnet_tpu_torch.parallel import group

    check(group.world() == MC_CARDS, f"{group.world()} ranks")
    out = {"card": torch.cuda.current_device(), "backend": dist_backend()}
    for key, dtype, hw, mode, extra, seed in MC_CASES:
        state, step = dp_state(dtype, hw, mode, **extra)
        batches = [rank_slice(global_batch(hw, seed + i, MC_CARDS))
                   for i in range(3)]
        res = one_step(state, step, batches[0])
        if group.rank():
            del res["state"]
        else:
            res["grads"] = grads_on_cpu(state)
        for batch in batches[1:]:
            step(state, batch)
        res["unequal"] = unequal_to_rank0(state)
        if dtype == "bfloat16":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            rotation = itertools.cycle(batches)
            res["ms"] = cuda_ms(lambda: step(state, next(rotation)), MC_STEPS,
                                warmup=0)
            res["timed_counts"] = launch_counts()
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            if group.rank() == 0:
                wall, device, launches = profile_window(
                    lambda: step(state, batches[0]), MC_PROFILE_ITERS)
                res["profile"] = {"wall_ms": wall, "launches": launches,
                                  **busy_split(device, MC_PROFILE_ITERS)}
            else:  # the same steps as rank 0's window, which has a warm-up
                for _ in range(1 + MC_PROFILE_ITERS):
                    step(state, batches[0])
                torch.cuda.synchronize()
            # the step's gradient all-reduce alone, the ranks aligned first
            modules = (state.model, state.d1, state.d2)
            res["grad_bytes"] = 4 * sum(p.numel() for m in modules if m is not None
                                        for p in m.parameters() if p.requires_grad)
            card_barrier()
            res["allreduce_ms"] = cuda_ms(lambda: group.all_reduce_grads(modules),
                                          MC_STEPS, warmup=0)
        if key == "multi-level bf16":
            res["resume"] = mc_resume(state, mode)
        out[key] = res
        del state
        torch.cuda.empty_cache()
    return out


def busy_split(device, iters: int) -> dict:
    """Device ms per call from profile_window's device events: 'busy_ms' of
    the kernels and copies, 'nccl_ms' of NCCL's kernels (a collective's
    kernel runs from its launch until every rank has joined), and
    'annotated_ms', busy with the device spans of user annotations
    (nccl:all_reduce, Optimizer.step#...) added, which repeat the time of
    the kernels under them; profile_eval counts those too."""
    per = 1e3 * iters
    kernels = [e for e in device if not (getattr(e, "is_user_annotation", False)
                                         or e.key.startswith("nccl:"))]
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    return {"busy_ms": sum(e.device_time_total for e in kernels) / per,
            "nccl_ms": sum(e.device_time_total for e in nccl) / per,
            "nccl_kernels": sorted({e.key[:48] for e in nccl}),
            "annotated_ms": sum(e.device_time_total for e in device) / per}


def mc_one_card(dtype, hw, mode, extra, seed) -> dict:
    """The reference of one MC_CASES case: one process on card 0 takes the
    first step on the whole global batch; a bf16 case is then timed as
    mc_train_rank times it, at the global batch and at its first image."""
    state, step = dp_state(dtype, hw, mode, **extra)
    start_state = state_on_cpu(state)
    batch = global_batch(hw, seed, MC_CARDS)
    ref = one_step(state, step, batch)
    ref["start"], ref["grads"] = start_state, grads_on_cpu(state)
    if dtype == "bfloat16":
        for label, b in (("b4", batch),
                         ("b1", {k: v[:, :1].contiguous() for k, v in batch.items()})):
            torch.cuda.reset_peak_memory_stats()
            ref[f"ms_{label}"] = cuda_ms(lambda: step(state, b), MC_STEPS,
                                         warmup=2)
            ref[f"peak_gib_{label}"] = torch.cuda.max_memory_allocated() / 2**30
            if label == "b1":
                _, device, _ = profile_window(lambda: step(state, b),
                                              MC_PROFILE_ITERS)
                ref["busy_b1"] = busy_split(device, MC_PROFILE_ITERS)
    del state
    torch.cuda.empty_cache()
    return ref


def mc_train(smi: str) -> None:
    """Phase 15 (a) and (b): MC_CASES on MC_CARDS NCCL ranks against one
    process on one card with the whole global batch."""
    refs = {key: mc_one_card(*case) for key, *case in MC_CASES}
    t0 = time.perf_counter()
    ranks = launch_cards(mc_train_rank)
    launch_s = time.perf_counter() - t0
    check([r["card"] for r in ranks] == list(range(MC_CARDS))
          and all(r["backend"] == "nccl" for r in ranks),
          f"ranks on cards {[(r['card'], r['backend']) for r in ranks]}")
    for key, dtype, hw, mode, extra, seed in MC_CASES:
        rs, ref = [r[key] for r in ranks], refs[key]
        check(all(r["metrics"] == rs[0]["metrics"] for r in rs),
              f"(a) {key}: the ranks' losses differ")
        errs, unsettled = mc_compare(rs[0], ref, ref["start"])
        raw = {k: v for k, v in compare_steps(rs[0], ref, ref["start"]).items()
               if k in unsettled}
        f32 = dtype == "float32"
        # PERF.md §2: f32 and bf16 limits; with bn_mode='batch' the f32
        # generator gradient (ill-conditioned through the batch
        # statistics) is held to 2e-2
        tols = {k: 1e-4 if k == "losses" else 1e-3 for k in errs} if f32 else {
            k: 2e-2 for k in errs}
        if f32 and extra.get("bn_mode") == "batch":
            tols["model grad"] = 2e-2
        check(all(errs[k] <= tols[k] for k in errs),
              f"(a) {key}: relative errors {errs} against one process, "
              f"limits {tols}; weights left out of the D updates {unsettled}")
        bad = {r: res["unequal"][:6] for r, res in enumerate(rs) if res["unequal"]}
        check(not bad, f"(a) {key}: after 3 steps, tensors unequal to rank "
              f"0's: {bad}")
        line = (f"phase 15: (a) NCCL, {MC_CARDS} ranks on cards "
                f"{[r['card'] for r in ranks]}, {key} {hw}, global batch "
                f"{MC_CARDS} (one image per card) vs one process on card 0 "
                f"with the whole batch: relative errors {json.dumps(errs)} "
                f"(limits {json.dumps(tols)}; D "
                f"weights whose sign the summation order picks, left out of "
                f"the D updates: {json.dumps(unsettled)}; with them, not "
                f"held: {json.dumps(raw)}); every parameter, "
                f"buffer and optimizer state equal on all ranks after 3 steps")
        if not f32:
            per_step = STEP_LAUNCHES[mode]
            for r, res in enumerate(rs):
                for counts, n in ((res["counts"], 1), (res["timed_counts"], MC_STEPS)):
                    check(all(counts.get(k, 0) == n * v for k, v in per_step.items())
                          and sum(counts.values()) == n * sum(per_step.values()),
                          f"(a) {key}: rank {r} launches {counts} in {n} "
                          f"step(s), expected {per_step} per step (phases 9 / 12)")
            prof, one = rs[0]["profile"], ref["busy_b1"]
            line += (
                f"; launches/step per rank {per_step} (phases 9 / 12's); "
                f"ms/step (CUDA events, {MC_STEPS} steps after 3) per rank "
                f"{[round(res['ms'], 3) for res in rs]} against one card's "
                f"{ref['ms_b1']:.3f} at batch 1 and {ref['ms_b4']:.3f} at "
                f"batch {MC_CARDS}; rank 0's profiler ({MC_PROFILE_ITERS} "
                f"steps): wall {prof['wall_ms']:.3f} ms/step, device busy "
                f"{prof['busy_ms']:.3f} ms/step ({100 * prof['busy_ms'] / prof['wall_ms']:.1f} "
                f"%; with the annotations' spans {prof['annotated_ms']:.3f}) "
                f"against one card's {one['busy_ms']:.3f} at batch 1 (with "
                f"the spans {one['annotated_ms']:.3f}), NCCL kernels "
                f"{prof['nccl_ms']:.3f} ms/step {prof['nccl_kernels']}, "
                f"{prof['launches']:g} launches/step; the gradient "
                f"all-reduce alone (ranks aligned, {MC_STEPS} calls) "
                f"{[round(res['allreduce_ms'], 3) for res in rs]} ms for "
                f"{rs[0]['grad_bytes']} B; peak memory per card "
                f"{[round(res['peak_gib'], 3) for res in rs]} GiB against one "
                f"card's {ref['peak_gib_b1']:.3f} at batch 1 and "
                f"{ref['peak_gib_b4']:.3f} at batch {MC_CARDS}")
        print(f"{line} [{smi}]")
    res = [r["multi-level bf16"]["resume"] for r in ranks]
    bad = {r: x["differ"][:6] for r, x in enumerate(res)
           if not x["resumed"] or x["differ"]}
    check(not bad, f"(b) the resume across cards differs: {bad}")
    print(f"phase 15: (b) full-state resume across cards: rank 0's "
          f"{res[0]['bytes']}-byte checkpoint (bf16 multi-level, step "
          f"{res[0]['step']}) "
          f"read by rank 0 alone and broadcast through NCCL into freshly "
          f"built states on {[x['device'] for x in res]}: every tensor, "
          f"optimizer states included, and the step exact on every rank; "
          f"{max(x['s'] for x in res):.2f} s (slowest rank) [{smi}]")
    print(f"phase 15: (a)+(b) launch of {MC_CARDS} NCCL ranks: {launch_s:.1f} s")


def mc_train_cli(smi: str) -> None:
    """Phase 15 (c): cli.train --num-devices MC_CARDS --batch-size
    MC_CARDS, 3 steps, multi-level and the default mode flags, then
    cli.evaluate on GTA5_3.pth; the multi-level command again under
    torchrun, whose snapshots must equal the spawned run's bit for bit."""
    from adaptsegnet_tpu_torch.data import lists
    from adaptsegnet_tpu_torch.utils import pth_interop

    root = os.path.join(WORK, "mc_train_cli")
    size = f"{TRAIN_IN[1]},{TRAIN_IN[0]}"
    gta = lists.make_synthetic_gta5(os.path.join(root, "gta5"), n=MC_CARDS,
                                    size_wh=TRAIN_IN[::-1])
    cs = lists.make_synthetic_cityscapes(os.path.join(root, "cs"), "train",
                                         n=MC_CARDS, size_wh=TRAIN_IN[::-1])
    val = lists.make_synthetic_cityscapes(os.path.join(root, "cs"), "val", n=2,
                                          size_wh=TRAIN_IN[::-1])
    gta_flags = ["--data-dir", os.path.dirname(gta), "--data-list", gta]
    multi = ["--no-warper", "--no-source-only", "--level", "multi-level",
             "--data-dir-target", os.path.dirname(cs), "--data-list-target",
             cs, "--input-size-target", size, *gta_flags]
    common = ["--compute-dtype", "bfloat16", "--input-size", size,
              "--num-steps", "100", "--num-steps-stop", "3", "--restore-from",
              "", "--num-workers", "2", "--num-devices", str(MC_CARDS),
              "--batch-size", str(MC_CARDS)]
    train = ["-m", "adaptsegnet_tpu_torch.cli.train"]
    torchrun = ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(MC_CARDS), *train]
    runs = (("multi_level", "multi_level", train, multi),
            ("source_only", "source_only", train, gta_flags),
            ("multi_level torchrun", "multi_level", torchrun, multi))
    loss_lines = {}
    for label, sub, launcher, flags in runs:
        snap = os.path.join(root, "snap_" + label.replace(" ", "_"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, *launcher, *flags, *common, "--snapshot-dir", snap],
            cwd=REPO, capture_output=True, text=True, timeout=MC_TIMEOUT_S)
        check(proc.returncode == 0, f"(c) cli.train {label} exited "
              f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        lines = [ln[ln.index("iter ="):] for ln in proc.stdout.splitlines()
                 if "iter =" in ln]
        check(len(lines) == 3 and all("nan" not in ln and "inf" not in ln
                                      for ln in lines),
              f"(c) cli.train {label}: loss lines {lines} (rank 0 alone prints)")
        loss_lines[label] = lines
        files = sorted(os.listdir(os.path.join(snap, sub)))
        want = sorted(["GTA5_3.pth", "full_state"] + (
            ["GTA5_3_D1.pth", "GTA5_3_D2.pth"] if sub == "multi_level" else []))
        check(files == want, f"(c) cli.train {label} wrote {files}, expected {want}")
        took = time.perf_counter() - t0
        note = ""
        if launcher is train:
            result = os.path.join(root, "result_" + label)
            proc = subprocess.run(
                [sys.executable, "-m", "adaptsegnet_tpu_torch.cli.evaluate",
                 "--data-dir", os.path.dirname(val), "--data-list", val,
                 "--restore-from", os.path.join(snap, sub, "GTA5_3.pth"),
                 "--save", result],
                cwd=REPO, capture_output=True, text=True, timeout=MC_TIMEOUT_S)
            check(proc.returncode == 0, f"(c) cli.evaluate exited "
                  f"{proc.returncode}:\n{proc.stderr[-4000:]}")
            pngs = os.listdir(result)
            check(len(pngs) == 4, f"(c) cli.evaluate wrote {pngs}")
            note = f"; cli.evaluate on GTA5_3.pth -> {len(pngs)} PNGs"
        else:
            spawned = os.path.join(root, "snap_multi_level", sub)
            for f in files:
                if not f.endswith(".pth"):
                    continue
                a = pth_interop.load_torch_state_dict(os.path.join(snap, sub, f))
                b = pth_interop.load_torch_state_dict(os.path.join(spawned, f))
                check(sorted(a) == sorted(b) and all(
                    torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
                    for k in a), f"(c) torchrun's {f} differs from the spawned run's")
            check(lines == loss_lines["multi_level"],
                  f"(c) torchrun's loss lines {lines} differ from the spawned "
                  f"run's {loss_lines['multi_level']}")
            note = ("; GTA5_3.pth, _D1 and _D2 equal to the spawned run's "
                    "bit for bit, and the loss lines too")
        print(f"phase 15: (c) cli.train bf16 {label} --num-devices {MC_CARDS} "
              f"--batch-size {MC_CARDS} 3 steps {TRAIN_IN} -> {files} (rank 0 "
              f"alone writes and prints); last loss line: {lines[-1]}{note} "
              f"({took:.1f} s with process start-up) [{smi}]")


def mc_eval_rank(ckpt: str, root: str, list_path: str, labels: dict,
                 images: np.ndarray) -> dict:
    """Phase 15 (d), as one of MC_CARDS NCCL ranks: f32
    Evaluator.run_streaming at a global batch of MC_CARDS, then the bf16
    batched forward of this rank's pair of `images` (kernels 3 and 1),
    counted once and then timed MC_EVAL_REPEATS times between barriers."""
    import torch.distributed as dist

    from adaptsegnet_tpu_torch.data import CityscapesDataset
    from adaptsegnet_tpu_torch.eval.evaluator import Evaluator, make_eval_fn
    from adaptsegnet_tpu_torch.models import DeeplabMulti
    from adaptsegnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from adaptsegnet_tpu_torch.parallel import group
    from adaptsegnet_tpu_torch.utils import pth_interop

    sd = pth_interop.load_torch_state_dict(ckpt)
    model = DeeplabMulti(device="cuda")
    pth_interop.load_into(model, sd)
    ds = CityscapesDataset(root, list_path, crop_size=EVAL_IN[::-1])
    hist = Evaluator(model.eval(), out_hw=EVAL_OUT, mesh=dist.group.WORLD
                     ).run_streaming(ds, lambda name: labels[name],
                                     batch_size=MC_CARDS, num_workers=2)
    del model
    bf16 = DeeplabMulti(dtype=torch.bfloat16, device="cuda")
    pth_interop.load_into(bf16, sd)
    fn = make_eval_fn(bf16.eval(), out_hw=EVAL_OUT, dtype=torch.bfloat16)
    r = group.rank()
    pair = torch.from_numpy(images[2 * r:2 * r + 2]).cuda()
    reset_launch_counts()
    masks = fn(pair)
    torch.cuda.synchronize()
    counts = launch_counts()
    card_barrier()
    t0 = time.perf_counter()
    for _ in range(MC_EVAL_REPEATS):
        fn(pair)
    card_barrier()
    return {"hist": hist, "masks": masks.cpu(), "counts": counts,
            "s": time.perf_counter() - t0, "card": torch.cuda.current_device()}


def mc_eval_data():
    """Phase 15 (d)'s synthetic Cityscapes val set of MC_EVAL_IMAGES images
    with gtFine labels and a devkit, and a checkpoint of DeeplabMulti with
    checkpoint-like BN statistics -> (root, list file, gt dir, devkit,
    checkpoint, the CPU model)."""
    from adaptsegnet_tpu_torch.data import lists
    from adaptsegnet_tpu_torch.models import DeeplabMulti
    from adaptsegnet_tpu_torch.utils import pth_interop

    root = os.path.join(WORK, "mc_eval")
    list_path = lists.make_synthetic_cityscapes(
        root, "val", n=MC_EVAL_IMAGES, size_wh=EVAL_IN[::-1], seed=SEED + 100)
    with open(list_path) as f:
        names = f.read().split()
    gt_dir, gt_names = lists.make_synthetic_cityscapes_gt(
        root, names, size_wh=EVAL_OUT[::-1], seed=SEED + 101)
    devkit = os.path.join(root, "devkit")
    lists.write_devkit(devkit, names, gt_names)
    g = torch.Generator().manual_seed(SEED + 102)
    cpu = DeeplabMulti(device="cpu", generator=g)
    checkpoint_like_bn_(cpu, g)
    ckpt = os.path.join(root, "m.pth")
    pth_interop.save_torch_state_dict(cpu.state_dict(), ckpt)
    return root, list_path, gt_dir, devkit, ckpt, cpu


def mc_eval_cli(data, smi: str) -> None:
    """Phase 15 (d): cli.evaluate --num-devices MC_CARDS (f32) against
    --num-devices 1 on the MC_EVAL_IMAGES images: PNGs and cli.iou exact."""
    root, list_path, gt_dir, devkit, ckpt, _ = data
    iou, secs = {}, {}
    for n in (1, MC_CARDS):
        pred = os.path.join(root, f"pred{n}")
        t0 = time.perf_counter()
        for cmd in (
            ["-m", "adaptsegnet_tpu_torch.cli.evaluate", "--data-dir", root,
             "--data-list", list_path, "--restore-from", ckpt, "--save", pred,
             "--num-devices", str(n), "--batch-size", str(n)],
            ["-m", "adaptsegnet_tpu_torch.cli.iou", "--gt_dir", gt_dir,
             "--pred_dir", pred, "--devkit_dir", devkit, "--single-dir"],
        ):
            proc = subprocess.run([sys.executable, *cmd], cwd=REPO,
                                  capture_output=True, text=True,
                                  timeout=MC_TIMEOUT_S)
            check(proc.returncode == 0, f"(d) {cmd[1]} --num-devices {n} "
                  f"exited {proc.returncode}:\n{proc.stderr[-4000:]}")
            if cmd[1].endswith("evaluate"):
                secs[n] = time.perf_counter() - t0
        iou[n] = [ln for ln in proc.stdout.splitlines() if ln.startswith("===>")]
    check(len(iou[1]) == 20 and iou[MC_CARDS] == iou[1],
          f"(d) cli.iou: {iou[MC_CARDS][-1:]} vs {iou[1][-1:]}")
    one, many = (os.path.join(root, f"pred{n}") for n in (1, MC_CARDS))
    pngs = sorted(os.listdir(one))
    check(sorted(os.listdir(many)) == pngs and len(pngs) == 2 * MC_EVAL_IMAGES,
          f"(d) PNGs: {sorted(os.listdir(many))} vs {pngs}")
    for name in pngs:
        check(np.array_equal(np.array(Image.open(os.path.join(many, name))),
                             np.array(Image.open(os.path.join(one, name)))),
              f"(d) {name} differs from the one-process PNG")
    print(f"phase 15: (d) cli.evaluate f32 --num-devices {MC_CARDS} "
          f"--batch-size {MC_CARDS} on {MC_EVAL_IMAGES} images {EVAL_IN} -> "
          f"{EVAL_OUT} (ragged tail): all {len(pngs)} PNGs and cli.iou's "
          f"lines ({iou[1][-1]}) equal to --num-devices 1 "
          f"({secs[MC_CARDS]:.1f} s against {secs[1]:.1f} s with process "
          f"start-up) [{smi}]")


def mc_eval_group(data, smi: str) -> None:
    """Phase 15 (d): the group's f32 run_streaming histogram against one
    process; each rank's bf16 batched pair bit for bit with the one-process
    forward, and img/s on MC_CARDS cards beside one."""
    from adaptsegnet_tpu_torch.data import CityscapesDataset
    from adaptsegnet_tpu_torch.eval.evaluator import Evaluator, make_eval_fn
    from adaptsegnet_tpu_torch.models import DeeplabMulti

    root, list_path, _, _, ckpt, cpu = data
    ds = CityscapesDataset(root, list_path, crop_size=EVAL_IN[::-1])
    rng = np.random.default_rng(SEED + 103)
    labels = {}
    for i in range(MC_EVAL_IMAGES):
        label = rng.integers(0, 19, EVAL_OUT).astype(np.uint8)
        label[rng.random(EVAL_OUT) < 0.2] = 255
        labels[ds[i][-1]] = label
    images = make_images(2 * MC_CARDS, EVAL_IN, SEED + 104)
    model = DeeplabMulti(device="cuda")
    model.load_state_dict(cpu.state_dict())
    hist = Evaluator(model.eval(), out_hw=EVAL_OUT).run_streaming(
        ds, lambda n: labels[n], batch_size=1)
    del model
    bf16 = DeeplabMulti(dtype=torch.bfloat16, device="cuda")
    bf16.load_state_dict(cpu.state_dict())
    fn = make_eval_fn(bf16.eval(), out_hw=EVAL_OUT, dtype=torch.bfloat16)
    pairs = [torch.from_numpy(images[i:i + 2]).cuda()
             for i in range(0, 2 * MC_CARDS, 2)]
    masks = [fn(p).cpu() for p in pairs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MC_EVAL_REPEATS):
        fn(pairs[0])
    torch.cuda.synchronize()
    one_card = 2 * MC_EVAL_REPEATS / (time.perf_counter() - t0)
    del bf16, cpu, pairs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = launch_cards(mc_eval_rank, ckpt, root, list_path, labels, images)
    launch_s = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        check(res["card"] == r, f"(d) rank {r} on card {res['card']}")
        check(np.array_equal(res["hist"], hist),
              f"(d) rank {r}: the histogram differs from the one-process one")
        check(torch.equal(res["masks"], masks[r]),
              f"(d) rank {r}: bf16 batched masks differ from the one-process ones")
        check(res["counts"].get("conv3x3_dil_batched_fwd") == BATCHED_EVAL_LAUNCHES
              and res["counts"].get("upsample_argmax") == 1
              and sum(res["counts"].values()) == BATCHED_EVAL_LAUNCHES + 1,
              f"(d) rank {r}: launches {res['counts']}")
    cards = 2 * MC_CARDS * MC_EVAL_REPEATS / max(res["s"] for res in ranks)
    print(f"phase 15: (d) the group's f32 Evaluator.run_streaming at a "
          f"global batch of {MC_CARDS} over the {MC_EVAL_IMAGES} images: the "
          f"histogram ({int(hist.sum())} valid pixels, 20 % ignored) equal to "
          f"one process's at batch 1 on every rank")
    print(f"phase 15: (d) bf16 batched forward, 2 images per card (kernel 3 "
          f"x{BATCHED_EVAL_LAUNCHES}, kernel 1 x1 per rank): each rank's masks "
          f"equal to the one-process forward of its pair; {cards:.2f} img/s on "
          f"{MC_CARDS} cards against {one_card:.2f} img/s on one "
          f"({MC_EVAL_REPEATS} forwards per card after one, host clock between "
          f"synchronised barriers); launch {launch_s:.1f} s [{smi}]")


def phase_multi_card(cards: list[str]) -> None:
    """Phase 15: data-parallel train and eval across MC_CARDS cards."""
    smi = " | ".join(cards)
    t0 = time.perf_counter()
    mc_train(smi)
    mc_train_cli(smi)
    data = mc_eval_data()
    mc_eval_cli(data, smi)
    mc_eval_group(data, smi)
    print(f"phase 15: passed in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from adaptsegnet_tpu_torch.ops.kernels import LIBRARIES, _build

    quick = "--kernels-only" in sys.argv[1:]
    dp_only = "--data-parallel-only" in sys.argv[1:]
    multi = "--multi-card" in sys.argv[1:]
    if multi and torch.cuda.device_count() < MC_CARDS:
        print(f"chip_smoke --multi-card: needs {MC_CARDS} CUDA cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    cards = nvidia_smi_cards()
    smi = cards[0]
    print(f"phase 1: device {torch.cuda.get_device_name(0)} (count "
          f"{torch.cuda.device_count()}), torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}; "
          f"nvidia-smi: {' | '.join(cards) if multi else smi}")

    t0 = time.perf_counter()
    logs = _build.build(list(LIBRARIES))
    ptxas = " | ".join(ln.strip() for log in logs.values()
                       for ln in log.splitlines()
                       if "Compiling entry function" in ln or "registers" in ln
                       or "spill" in ln)
    print(f"phase 2: built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s; ptxas: {ptxas}")

    results: dict = {"path_launches": {}}
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        if multi:
            phase_multi_card(cards)
            return 0
        phase_kernels(results, smi)
        if quick:
            phase_train_kernels(smi)
            return 0
        if dp_only:
            phase_train(smi, results, "multi-level")
            phase_train(smi, results, "source-only")
            phase_data_parallel(smi, results)
            return 0
        cpu_model, models = build_models((torch.bfloat16, torch.float32))
        phase_bf16_eval(models[torch.bfloat16], results, smi)
        phase_f32_card_vs_cpu(cpu_model, models[torch.float32])
        phase_cli(cpu_model)
        kernel = phase_timings(models, results, smi)
        phase_evaluator(models[torch.float32], smi,
                        results[f"eval_ms_{torch.float32}"])
        del cpu_model, models
        torch.cuda.empty_cache()
        train_rows = phase_train_kernels(smi)
        phase_train(smi, results, "multi-level")
        phase_train_parity()
        phase_train_cli()
        phase_train(smi, results, "source-only")
        phase_train(smi, results, "source-only", dtype="float32", steps=3)
        phase_model_families(smi, results)
        phase_data_parallel(smi, results)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    rows = [kernel, *train_rows.values()]
    for row in rows:  # summed over the runs of every driven main path
        row["launches"] = sum(c[row["name"]]
                              for c in results["path_launches"].values())
        check(row["launches"] > 0 or row["name"] in OFF_PATH,
              f"{row['name']} was launched on no main path")
    print("launches by path: " + json.dumps(
        {path: {k: v for k, v in c.items() if v}
         for path, c in results["path_launches"].items()}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
