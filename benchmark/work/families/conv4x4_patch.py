"""Family `conv4x4_patch`: kernel 4, the discriminators' conv1 over the
planar softmax map (csrc/conv4x4_patch.cu: `fwd_kernel`, `dgrad_kernel`,
`wgrad_kernel`, whose CUDA names take a tensor map first; the wgrad's
split sums, `sum_splits_kernel`, follow it).

Work of one launch: the convolution's operations at bf16 tensor-core
rate; bytes: the map, the weights and the output (or the output gradient
and the map gradient) in bf16, the forward's float32 bias, the wgrad's
float32 weight gradient.
"""

PEAK = "bf16"
WRAPPERS = ("conv4x4_patch_fwd", "conv4x4_patch_dgrad", "conv4x4_patch_wgrad")
KERNEL = r"::(fwd|dgrad|wgrad)_kernel\(CUtensorMap"
SECOND_PASS = r"sum_splits_kernel"


def work(launch: dict) -> tuple[int, int]:
    c, n = launch["conv"], launch["n"]
    ops = 2 * n * c["ho"] * c["wo"] * c["cout"] * c["cin"] * 16
    x = n * c["h"] * c["w"] * c["cin"]
    y = n * c["ho"] * c["wo"] * c["cout"]
    w = 16 * c["cin"] * c["cout"]
    kind = launch["wrapper"].rsplit("_", 1)[1]
    if kind == "fwd":
        return ops, 2 * (x + y + w) + 4 * c["cout"]
    if kind == "dgrad":
        return ops, 2 * (x + y + w)
    return ops, 2 * (x + y) + 4 * w
