"""conv4x4_patch_roofline: the conv4x4_patch family's least time over its device time
(layer: kernels; moves train_img_s)."""

from benchmark.lib.readers import roofline

read = roofline("conv4x4_patch")
