"""`python -m adaptsegnet_tpu_torch.cli.evaluate <flags>` — Cityscapes val
inference on the CUDA card (`--cpu` for the CPU).

Same flags as the JAX package's CLI (reference evaluate_cityscapes.py:62-93).
Iterates snapshots (num_steps_stop / save_pred_every) or evaluates a single
--restore-from checkpoint, writing raw-id + palette PNGs per image under
<save>/<mode>/step<k>/. `--model` picks DeeplabMulti (the main head of two),
Oracle (DeeplabSingle) or DeeplabVGG (single-output; `--aspp-sum`, default
'first2', for their released checkpoints). The forward runs in f32 with the
exact tail, as in the JAX CLI (adaptsegnet_tpu/eval/evaluator.py:125), so it
reaches neither the fused bf16 tail nor the batched bf16 3x3 kernel:
`make_eval_fn(model, dtype=torch.bfloat16)` is their path.

`--num-devices N` (default 1; 0 = every visible card) evaluates on N ranks,
one process per card (NCCL; gloo with --cpu, where N counts processes):
each takes the interleaved slice of the images at a local batch of
--batch-size / N (which must divide) and writes its own PNGs (JAX
`:52-56`). Started by torchrun, each process joins torchrun's group.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import torch

from adaptsegnet_tpu_torch.data import CityscapesDataset
from adaptsegnet_tpu_torch.device import resolve_device
from adaptsegnet_tpu_torch.eval.evaluator import Evaluator
from adaptsegnet_tpu_torch.models import DeeplabMulti, DeeplabSingle, DeeplabVGG
from adaptsegnet_tpu_torch.parallel import group
from adaptsegnet_tpu_torch.utils import pth_interop

_INIT_SEED = 1338  # the JAX CLI's init key; absent checkpoint keys keep it


def get_arguments(argv=None):
    p = argparse.ArgumentParser(description="DeepLab-ResNet Network (CUDA eval)")
    p.add_argument("--model", type=str, default="DeeplabMulti",
                   help="Model Choice (DeeplabMulti/DeeplabVGG/Oracle).")
    p.add_argument("--data-dir", type=str, default="./data/CityScapes")
    p.add_argument("--data-list", type=str,
                   default="./dataset/cityscapes_list/val.txt")
    p.add_argument("--ignore-label", type=int, default=255)
    p.add_argument("--num-classes", type=int, default=19)
    p.add_argument("--restore-from", type=str, default="",
                   help="Evaluate one checkpoint instead of the snapshot loop.")
    p.add_argument("--set", type=str, default="val")
    p.add_argument("--save", type=str, default="./result/cityscapes")
    p.add_argument("--save-pred-every", type=int, default=5000)
    p.add_argument("--num-steps-stop", type=int, default=150000)
    p.add_argument("--level", type=str, default="single-level")
    p.add_argument("--source-only", dest="source_only", action="store_true",
                   default=True)
    p.add_argument("--no-source-only", dest="source_only", action="store_false")
    p.add_argument("--snapshot-dir", type=str, default="./snapshots")
    p.add_argument("--input-size", type=str, default="1024,512",
                   help="W,H network input (reference fwd at 512x1024).")
    p.add_argument("--output-size", type=str, default="2048,1024",
                   help="W,H of the upsampled prediction (reference :153).")
    p.add_argument("--aspp-sum", type=str, default="")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-devices", type=int, default=1,
                   help="Shard the eval batch over this many devices, one "
                        "process each (the reference DataParallels eval by "
                        "default, evaluate_cityscapes.py:92,145); "
                        "batch-size must be a multiple. 0 = all devices.")
    p.add_argument("--cpu", action="store_true",
                   help="choose to use cpu device.")
    return p.parse_args(argv)


def build_model(args, device: torch.device):
    """(model, output_index): DeeplabMulti's main head is output 1; the
    single-output models return a bare map, which the eval fn does not
    index (JAX cli/evaluate.py:62-79, 107-113)."""
    generator = torch.Generator().manual_seed(_INIT_SEED)
    if args.model == "DeeplabMulti":
        if args.aspp_sum not in ("", "all"):
            raise ValueError("DeeplabMulti sums all four ASPP branches; "
                             f"--aspp-sum {args.aspp_sum} is not supported")
        return DeeplabMulti(num_classes=args.num_classes, device=device,
                            generator=generator), 1
    single = {"Oracle": DeeplabSingle, "DeeplabVGG": DeeplabVGG}
    if args.model not in single:
        raise NotImplementedError(args.model)
    return single[args.model](
        num_classes=args.num_classes, aspp_sum=args.aspp_sum or "first2",
        device=device, generator=generator), 0


def _mode_subdir(args) -> str:
    if args.source_only:
        return "source_only"
    return {"single-level": "single_level", "multi-level": "multi_level"}[
        args.level
    ]


def evaluate_checkpoint(args, model, output_index, ckpt_path, save_dir):
    pth_interop.load_into(model, pth_interop.load_torch_state_dict(ckpt_path))
    ow, oh = map(int, args.output_size.split(","))
    mesh = None
    if group.active():
        import torch.distributed as dist

        mesh = dist.group.WORLD
    evaluator = Evaluator(model, out_hw=(oh, ow), output_index=output_index,
                          save_dir=save_dir, mesh=mesh)
    w, h = map(int, args.input_size.split(","))
    ds = CityscapesDataset(args.data_dir, args.data_list, crop_size=(w, h),
                           set=args.set)
    return evaluator.run(ds, batch_size=args.batch_size)


def main(argv=None):
    args = get_arguments(argv)
    ranks = args.num_devices or group.device_count(args.cpu)
    if ranks > 1 or group.started_by_torchrun():
        group.launch(run, ranks, cpu=args.cpu, args=(args,))
    else:
        run(args)


def run(args) -> None:
    """Evaluate the checkpoints of `args` in this process (one rank of a
    group, or alone)."""
    device = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.save, exist_ok=True)
    model, output_index = build_model(args, device)

    if args.restore_from:
        ckpts = [(None, args.restore_from)]
    else:
        ckpts = []
        for files in range(int(args.num_steps_stop / args.save_pred_every)):
            step = (files + 1) * args.save_pred_every
            ckpts.append(
                (step,
                 osp.join(args.snapshot_dir, _mode_subdir(args),
                          f"GTA5_{step}.pth"))
            )

    for step, path in ckpts:
        if step is not None and group.rank() == 0:
            print("Step: ", step)
        if not osp.exists(path):
            if group.rank() == 0:
                print(f"missing snapshot {path}; skipping")
            continue
        sub = (osp.join(args.save, _mode_subdir(args), f"step{step}")
               if step is not None else args.save)
        evaluate_checkpoint(args, model, output_index, path, sub)


if __name__ == "__main__":
    main()
