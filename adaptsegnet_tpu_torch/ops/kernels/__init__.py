"""Hand-written CUDA kernels of the port and their launch counts.

Each kernel direction's wrapper carries a `launches` integer that grows by
one per launch; `KERNELS` lists the wrappers so a run can zero and read the
counts. `LIBRARIES` names the CUDA sources (csrc/<name>.cu), one shared
library each.
"""

from adaptsegnet_tpu_torch.ops.kernels.conv3x3_dil import (
    conv3x3_dil_batched_fwd,
    conv3x3_dil_dgrad,
    conv3x3_dil_fwd,
)
from adaptsegnet_tpu_torch.ops.kernels.conv4x4_patch import (
    conv4x4_patch_dgrad,
    conv4x4_patch_fwd,
    conv4x4_patch_wgrad,
)
from adaptsegnet_tpu_torch.ops.kernels.conv4x4_s2 import (
    conv4x4_s2_dgrad,
    conv4x4_s2_fwd,
    conv4x4_s2_wgrad,
)
from adaptsegnet_tpu_torch.ops.kernels.upsample_argmax import (
    upsample_argmax,
    upsample_argmax_plain,
)
from adaptsegnet_tpu_torch.ops.kernels.upsample_warp import (
    upsample_warp_dflow,
    upsample_warp_dx,
    upsample_warp_fwd,
)

KERNELS = {fn.__name__: fn for fn in (
    upsample_argmax,
    conv3x3_dil_fwd, conv3x3_dil_dgrad, conv3x3_dil_batched_fwd,
    conv4x4_s2_fwd, conv4x4_s2_dgrad, conv4x4_s2_wgrad,
    conv4x4_patch_fwd, conv4x4_patch_dgrad, conv4x4_patch_wgrad,
    upsample_warp_fwd, upsample_warp_dx, upsample_warp_dflow,
)}
LIBRARIES = ("upsample_argmax", "conv3x3_dil", "conv4x4_s2", "conv4x4_patch",
             "upsample_warp")


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "LIBRARIES",
    "conv3x3_dil_batched_fwd",
    "conv3x3_dil_dgrad",
    "conv3x3_dil_fwd",
    "conv4x4_patch_dgrad",
    "conv4x4_patch_fwd",
    "conv4x4_patch_wgrad",
    "conv4x4_s2_dgrad",
    "conv4x4_s2_fwd",
    "conv4x4_s2_wgrad",
    "launch_counts",
    "reset_launch_counts",
    "upsample_argmax",
    "upsample_argmax_plain",
    "upsample_warp_dflow",
    "upsample_warp_dx",
    "upsample_warp_fwd",
]
