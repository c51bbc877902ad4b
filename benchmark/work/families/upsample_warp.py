"""Family `upsample_warp`: kernel 6, the Warper's fused upsample and warp
(csrc/upsample_warp.cu: `fwd_kernel<T>`, `dx_kernel<T>` with its
`round_kernel<T>`, `dflow_kernel<T>`).

Work of one launch, as the kernel table of PERF.md counts it: per output
pixel and channel 9 fused multiply-adds (the bilinear weights of the
upsample folded into the warp's four taps), float32 on the CUDA cores;
bytes: the low-resolution logits (or their gradient), the planar output
(or its gradient) in the logits' type, and the two float32 coordinates
of each output pixel, once each.
"""

PEAK = "f32"
WRAPPERS = ("upsample_warp_fwd", "upsample_warp_dx", "upsample_warp_dflow")
KERNEL = r"::(fwd|dx|dflow)_kernel<"
SECOND_PASS = r"::round_kernel<"


def work(launch: dict) -> tuple[int, int]:
    n, c, es = launch["n"], launch["c"], launch["es"]
    p = launch["oh"] * launch["ow"]
    ops = 2 * 9 * n * p * c
    nbytes = es * n * (launch["h"] * launch["w"] * c + p * c) + 8 * n * p
    if launch["wrapper"] == "upsample_warp_dflow":
        ops += 2 * 2 * 9 * n * p
        nbytes += 8 * n * p
    return ops, nbytes
