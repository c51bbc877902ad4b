"""Family `igemm_core`: the Hopper implicit-GEMM core's convolution kernel
(csrc/igemm_sm90.cuh, `conv_sm90_kernel`) with the second pass of its
split-K sums (csrc/splitk.cuh, `sum_splits_bf16_kernel`). It carries
kernel 2 (the dilated 3x3 forward and dgrad of the train path), kernel 3
(the batched 3x3 forward of the eval path) and kernel 5's forward and
dgrad (the discriminators' and the Warper encoder's 4x4/2 convolutions).

Work of one launch: the convolution's operations at bf16 tensor-core
rate; bytes: its input, weights and output in bf16 once each, and a
forward's float32 bias.
"""

PEAK = "bf16"
WRAPPERS = ("conv3x3_dil_fwd", "conv3x3_dil_dgrad", "conv3x3_dil_batched_fwd",
            "conv4x4_s2_fwd", "conv4x4_s2_dgrad")
KERNEL = r"conv_sm90_kernel"
# A second pass follows its main kernel on the stream; it is counted with
# the family of the hand-written kernel before it.
SECOND_PASS = r"sum_splits_bf16_kernel"


def work(launch: dict) -> tuple[int, int]:
    c, n = launch["conv"], launch["n"]
    ops = 2 * n * c["ho"] * c["wo"] * c["cout"] * c["cin"] * c["k"] ** 2
    pixels_in, pixels_out = n * c["h"] * c["w"], n * c["ho"] * c["wo"]
    nbytes = 2 * (pixels_in * c["cin"] + pixels_out * c["cout"]
                  + c["cout"] * c["cin"] * c["k"] ** 2)
    if launch["wrapper"] == "conv4x4_s2_fwd" and c["bias"]:
        nbytes += 4 * c["cout"]
    return ops, nbytes
