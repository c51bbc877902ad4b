"""Hand-written CUDA kernels of the port and their launch counts.

Each kernel's wrapper carries a `launches` integer that grows by one per
launch; `KERNELS` lists the wrappers so a run can zero and read the counts.
"""

from adaptsegnet_tpu_torch.ops.kernels.upsample_argmax import (
    upsample_argmax,
    upsample_argmax_plain,
)

KERNELS = {"upsample_argmax": upsample_argmax}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "upsample_argmax",
    "upsample_argmax_plain",
]
