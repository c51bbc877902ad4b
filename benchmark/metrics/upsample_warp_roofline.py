"""upsample_warp_roofline: the upsample_warp family's least time over its device time
(layer: kernels; moves train_img_s)."""

from benchmark.lib.readers import roofline

read = roofline("upsample_warp")
