#!/usr/bin/env python3
"""Rehearse `chip_smoke.py --multi-card` (phase 15) on one CUDA card.

    python3 scripts/multi_card_rehearsal.py

Phase 15 needs four cards, which cost four times as much per second. This
runs its in-process parts on one card first: (a) the three step cases
against one process, (b) the resume, and (d)'s group part (the f32
run_streaming histogram and each rank's bf16 batched pair), with the four
ranks as gloo processes that share card 0 (NCCL refuses two ranks on one
card). It finds faults in the script and in the group's numerics; its
ms/step, device-busy and img/s numbers are not data-parallel throughput
(four ranks share one card, and gloo goes through the host). A failed
check is printed and the run goes on; the checks that only four cards can
pass (each rank on its own card, the NCCL backend) fail here by design. The
parts that start processes of their own ((c) and (d)'s CLI runs, which ask
for four cards) are left out. Exits 1 if any other check failed.
"""

from __future__ import annotations

import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from adaptsegnet_tpu_torch.ops.kernels import LIBRARIES, _build  # noqa: E402
from adaptsegnet_tpu_torch.parallel import group  # noqa: E402

# what four ranks on one card cannot pass
BY_DESIGN = ("ranks on cards", "on card 0")


def launch_on_card0(fn, *args):
    return group.launch(fn, cs.MC_CARDS, args=args, backend="gloo",
                        devices=[0] * cs.MC_CARDS, timeout=cs.MC_TIMEOUT_S)


def main() -> int:
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)
            print(f"check failed: {msg[:1500]}", flush=True)

    cs.launch_cards = launch_on_card0
    cs.check = check
    print(f"[{cs.nvidia_smi()}]")
    t0 = time.perf_counter()
    _build.build(list(LIBRARIES))
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(cs.WORK, ignore_errors=True)
    os.makedirs(cs.WORK)
    try:
        cs.mc_train("4 gloo ranks on card 0")
        cs.mc_eval_group(cs.mc_eval_data(), "4 gloo ranks on card 0")
    finally:
        shutil.rmtree(cs.WORK, ignore_errors=True)
    real = [m for m in failed if not any(b in m for b in BY_DESIGN)]
    print(f"{len(failed)} checks failed, {len(real)} of them not by design")
    return 1 if real else 0


if __name__ == "__main__":
    sys.exit(main())
