"""`python -m adaptsegnet_tpu_torch.cli.iou --gt_dir --pred_dir --devkit_dir`
— offline mIoU.

Reference CLI surface (compute_iou.py:90-104): loops the snapshot step dirs
under pred_dir/<mode>/step<k> or scores a single prediction directory.
"""

from __future__ import annotations

import argparse
from os.path import isdir, join

from adaptsegnet_tpu_torch.eval.compute_iou import compute_mIoU


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gt_dir", type=str, default="./data/CityScapes/gtFine/val")
    p.add_argument("--pred_dir", type=str, default="./result/cityscapes")
    p.add_argument("--devkit_dir", default="dataset/cityscapes_list")
    p.add_argument("--save-pred-every", type=int, default=5000)
    p.add_argument("--num-steps-stop", type=int, default=150000)
    p.add_argument("--level", type=str, default="single-level")
    p.add_argument("--source-only", dest="source_only", action="store_true",
                   default=True)
    p.add_argument("--no-source-only", dest="source_only", action="store_false")
    p.add_argument("--single-dir", action="store_true",
                   help="Score pred_dir directly (no step subdir loop).")
    args = p.parse_args(argv)

    if args.single_dir:
        compute_mIoU(args.gt_dir, args.pred_dir, args.devkit_dir)
        return

    mode = ("source_only" if args.source_only else
            {"single-level": "single_level",
             "multi-level": "multi_level"}[args.level])
    for files in range(int(args.num_steps_stop / args.save_pred_every)):
        step = (files + 1) * args.save_pred_every
        pred_dir = join(args.pred_dir, mode, f"step{step}")
        if not isdir(pred_dir):
            continue
        print("Step: ", step)
        compute_mIoU(args.gt_dir, pred_dir, args.devkit_dir)


if __name__ == "__main__":
    main()
