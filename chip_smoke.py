#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card and check them.

    python3 chip_smoke.py                 # from the repository root; one card
    python3 chip_smoke.py --kernels-only  # phases 1-3 and 8 only: build the
                                          # kernels and hold each against its
                                          # plain version (no contract lines)

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
     cli.evaluate --model Oracle and --model DeeplabVGG, then cli.iou.
Then a `{"kernels": [...]}` line, the nvidia-smi line, and the last line
`{"ok": true, "device": {...}}`.

Weights come from a fixed torch.Generator with the reference's init law
(conv weights N(0, 0.01)); the frozen-BN statistics are then drawn from the
same generator, checkpoint-like, because at init (scale 1, mean 0, var 1)
the logits of the 101-layer net nearly vanish and every mask would be one
class. Images are made with numpy from a seed.
"""

from __future__ import annotations

import contextlib
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
EVAL_IN, EVAL_OUT = (512, 1024), (1024, 2048)
SEED = 0
# Kernel-3 launches of one batched bf16 ResNet-101 forward: the stride-1 3x3
# convs of layer2 (4 blocks, C 128, d 1), layer3 (23, C 256, d 2) and layer4
# (3, C 512, d 4); layer1's have 64 channels and keep cuDNN.
BATCHED_EVAL_LAUNCHES = 4 + 23 + 3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


def profile_eval(fn, iters: int = 5) -> str:
    """Where one eval's time goes: torch.profiler over `iters` calls after
    one warm-up -> wall and device-busy ms per call, kernel launches per
    call, and the five kernels with the most device time."""
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
    # Kernels (and device copies) only: a CPU op's own entry repeats the
    # device time of the kernels it launched.
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in device) / 1e3 / iters
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC", "cuLaunchKernelEx")) / iters
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from adaptsegnet_tpu_torch.ops.kernels import LIBRARIES, _build

    quick = "--kernels-only" in sys.argv[1:]
    smi = nvidia_smi()
    print(f"phase 1: device {torch.cuda.get_device_name(0)} (count "
          f"{torch.cuda.device_count()}), torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}; "
          f"nvidia-smi: {smi}")

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
        phase_kernels(results, smi)
        if quick:
            phase_train_kernels(smi)
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
