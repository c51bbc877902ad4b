"""conv4x4_wgrad_roofline: the conv4x4_wgrad family's least time over its device time
(layer: kernels; moves train_img_s)."""

from benchmark.lib.readers import roofline

read = roofline("conv4x4_wgrad")
