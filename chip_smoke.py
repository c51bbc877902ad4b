#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

The port's main path is DeeplabMulti evaluation: ResNet-101 forward at
512x1024 -> align-corners upsample to 1024x2048 -> first-index argmax ->
uint8 masks -> PNGs -> mIoU. Phases, each printing one line (any failure
exits nonzero, and there is no CPU fallback):
  1. device, torch and CUDA versions, nvidia-smi name and power limit;
  2. build the CUDA kernels from adaptsegnet_tpu_torch/csrc (one nvcc each,
     started together);
  3. hold each kernel against its plain PyTorch version on the card;
  4. full-width bf16 eval through make_eval_fn (the kernel's main path):
     launch counts zeroed before, read after; kernel tail vs plain tail;
  5. f32 eval on the card vs the CPU, same weights, 256x512 -> 512x1024
     (catches TF32 left on);
  6. the CLI: cli.evaluate on synthetic Cityscapes, then cli.iou;
  7. timings with CUDA events after warm-up, a torch.profiler window over
     the eval (device-busy share, launches, top kernels), and the
     Evaluator's steady end-to-end rate with host decode and PNG writes
     (two runs of 20 and 120 images differenced, so the pipeline's fill
     and drain are timed apart).
Then a `{"kernels": [...]}` line, the nvidia-smi line, and the last line
`{"ok": true, "device": {...}}`.

Weights come from a fixed torch.Generator with the reference's init law
(conv weights N(0, 0.01)); the frozen-BN statistics are then drawn from the
same generator, checkpoint-like, because at init (scale 1, mean 0, var 1)
the logits of the 101-layer net nearly vanish and every mask would be one
class. Images are made with numpy from a seed.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "_smoke_work")  # git-ignored scratch, removed at exit
EVAL_IN, EVAL_OUT = (512, 1024), (1024, 2048)
SEED = 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
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


def phase_kernels(results: dict) -> None:
    from adaptsegnet_tpu_torch.ops.kernels import (
        upsample_argmax,
        upsample_argmax_plain,
    )
    from adaptsegnet_tpu_torch.ops.resize import resize_bilinear_align_corners

    rng = np.random.default_rng(SEED)
    cases = [((1, 64, 128, 19), EVAL_OUT), ((2, 8, 16, 19), (32, 256)),
             ((1, 4, 8, 5), (4, 8))]
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


def phase_bf16_eval(model, results: dict) -> None:
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
    results["launches"] = counts
    worst, agrees = results["max_abs_err"], []
    with torch.inference_mode():
        for i in range(4):
            logits = model(images[i:i + 1])[1].contiguous()
            up = resize_bilinear_align_corners(logits.float(), EVAL_OUT)
            agree, err = compare_masks(upsample_argmax(logits, EVAL_OUT), up, False)
            compare_masks(masks[i], up, False)
            agrees.append(agree)
            worst = max(worst, err)
            if i == 0:
                results["eval_logits"] = logits
    results["max_abs_err"] = worst
    classes = len(torch.unique(torch.cat(masks)))
    print(f"phase 4: bf16 DeeplabMulti eval 4x{EVAL_IN} -> {EVAL_OUT} uint8 "
          f"masks, launches {counts}, kernel vs plain tail agreement "
          f"min {min(agrees):.6f}, {classes} classes present")


def phase_f32_card_vs_cpu(cpu_model, card_model) -> None:
    from adaptsegnet_tpu_torch.eval.evaluator import make_eval_fn
    from adaptsegnet_tpu_torch.ops.resize import upsample_logits

    in_hw, out_hw = (256, 512), (512, 1024)
    images = torch.from_numpy(make_images(2, in_hw, SEED + 2))
    card = make_eval_fn(card_model, out_hw=out_hw)(images.cuda()).cpu()
    cpu = make_eval_fn(cpu_model, out_hw=out_hw)(images)
    with torch.inference_mode():
        up = upsample_logits(cpu_model(images)[1], out_hw, exact=True)
    eq = card == cpu
    agree = eq.float().mean().item()
    top2 = up.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1])[~eq]
    worst = margin.max().item() if margin.numel() else 0.0
    check(agree >= 0.999 and worst < 1e-3,
          f"f32 card vs CPU masks agree {agree:.6f} (need 0.999), largest "
          f"mismatch margin {worst:.3g} (need < 1e-3)")
    print(f"phase 5: f32 eval card vs CPU 2x{in_hw} -> {out_hw}: agreement "
          f"{agree:.6f}, {int((~eq).sum())} mismatches, largest CPU top-2 "
          f"margin at a mismatch {worst:.3g}")


def phase_cli(cpu_model) -> None:
    from adaptsegnet_tpu_torch.data import lists
    from adaptsegnet_tpu_torch.utils import pth_interop

    root = os.path.join(WORK, "cityscapes")
    list_path = lists.make_synthetic_cityscapes(
        root, "val", n=2, size_wh=EVAL_IN[::-1])
    with open(list_path) as f:
        names = f.read().split()
    gt_dir, labels = lists.make_synthetic_cityscapes_gt(
        root, names, size_wh=EVAL_OUT[::-1])
    devkit = os.path.join(WORK, "devkit")
    lists.write_devkit(devkit, names, labels)
    ckpt = os.path.join(WORK, "GTA5_smoke.pth")
    pth_interop.save_torch_state_dict(cpu_model.state_dict(), ckpt)
    pred_dir = os.path.join(WORK, "result")
    t0 = time.perf_counter()
    for cmd in (
        ["-m", "adaptsegnet_tpu_torch.cli.evaluate", "--data-dir", root,
         "--data-list", list_path, "--restore-from", ckpt, "--save", pred_dir],
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
    print(f"phase 6: cli.evaluate (f32, {EVAL_IN} -> {EVAL_OUT}) + cli.iou on "
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
    n, h, w, c = logits.shape
    oh, ow = EVAL_OUT
    kernel_ms = cuda_ms(lambda: upsample_argmax(logits, EVAL_OUT), iters=200)
    plain_ms = cuda_ms(lambda: upsample_argmax_plain(logits, EVAL_OUT), iters=20)
    library_ms = cuda_ms(lambda: F.interpolate(
        logits.permute(0, 3, 1, 2).float(), EVAL_OUT, mode="bilinear",
        align_corners=True).argmax(1).to(torch.uint8), iters=20)
    # Least work of the function: read the logits and the 4 weight tables
    # once, write the mask once; per output pixel and channel a width lerp
    # (mul + fma = 3 flops) and a compare, per output row, needed source
    # column and channel a height lerp (3 flops). f32 on CUDA cores:
    # 67 TFLOP/s peak; 3.35 TB/s HBM (H100 SXM data sheet).
    bytes_moved = (logits.numel() * logits.element_size() + n * oh * ow
                   + 8 * (2 * oh + 2 * ow))
    ops = n * oh * ow * c * 4 + n * oh * w * c * 3
    bytes_ms = bytes_moved / 3.35e12 * 1e3
    ops_ms = ops / 67e12 * 1e3
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
        "launches": results["launches"]["upsample_argmax"],
        "max_abs_err": results["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from adaptsegnet_tpu_torch.ops.kernels import KERNELS, _build

    smi = nvidia_smi()
    print(f"phase 1: device {torch.cuda.get_device_name(0)} (count "
          f"{torch.cuda.device_count()}), torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}; "
          f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    logs = _build.build(list(KERNELS))
    ptxas = " | ".join(ln.strip() for log in logs.values()
                       for ln in log.splitlines() if "registers" in ln)
    print(f"phase 2: built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s; ptxas: {ptxas}")

    results: dict = {}
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        phase_kernels(results)
        cpu_model, models = build_models((torch.bfloat16, torch.float32))
        phase_bf16_eval(models[torch.bfloat16], results)
        phase_f32_card_vs_cpu(cpu_model, models[torch.float32])
        phase_cli(cpu_model)
        kernel = phase_timings(models, results, smi)
        phase_evaluator(models[torch.float32], smi,
                        results[f"eval_ms_{torch.float32}"])
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
