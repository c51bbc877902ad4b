"""igemm_core.eval_roofline: the igemm_core family's least time over its device time
(layer: kernels; moves eval_img_s)."""

from benchmark.lib.readers import roofline

read = roofline("igemm_core")
