"""Family `conv4x4_wgrad`: kernel 5's weight gradient
(csrc/conv4x4_s2.cu, `wgrad_sm90_kernel`) with its split sums where split
(`sum_splits_kernel`, float32 out): the discriminators' conv2 to conv4.

Work of one launch: the convolution's operations at bf16 tensor-core
rate; bytes: the input and the output gradient in bf16, the float32
weight gradient.
"""

PEAK = "bf16"
WRAPPERS = ("conv4x4_s2_wgrad",)
KERNEL = r"wgrad_sm90_kernel"
SECOND_PASS = r"sum_splits_kernel"


def work(launch: dict) -> tuple[int, int]:
    c, n = launch["conv"], launch["n"]
    ops = 2 * n * c["ho"] * c["wo"] * c["cout"] * c["cin"] * 16
    nbytes = (2 * n * (c["h"] * c["w"] * c["cin"] + c["ho"] * c["wo"] * c["cout"])
              + 4 * 16 * c["cin"] * c["cout"])
    return ops, nbytes
