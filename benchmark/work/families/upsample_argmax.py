"""Family `upsample_argmax`: kernel 1, the eval tail's align-corners
upsample of the logits fused with the argmax over classes
(csrc/upsample_argmax.cu, `upsample_argmax_kernel`).

Work of one launch: per output pixel and class a width lerp (3
operations) and a compare, per output row, source column and class a
height lerp (3), float32 on the CUDA cores; bytes: the logits once, the
uint8 mask once, and the four interpolation tables.
"""

PEAK = "f32"
WRAPPERS = ("upsample_argmax",)
KERNEL = r"upsample_argmax_kernel"
SECOND_PASS = None


def work(launch: dict) -> tuple[int, int]:
    n, h, w, c = launch["n"], launch["h"], launch["w"], launch["c"]
    oh, ow = launch["oh"], launch["ow"]
    ops = n * oh * ow * c * 4 + n * oh * w * c * 3
    nbytes = (n * h * w * c * launch["es"] + n * oh * ow
              + 8 * (2 * oh + 2 * ow))
    return ops, nbytes
