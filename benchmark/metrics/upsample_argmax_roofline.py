"""upsample_argmax_roofline: the upsample_argmax family's least time over its device time
(layer: kernels; moves eval_img_s)."""

from benchmark.lib.readers import roofline

read = roofline("upsample_argmax")
