"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at its
700 W limit): the yardstick of every roofline and MFU share."""

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def least_seconds(ops: float, nbytes: float, peak: str) -> float:
    """The least time the card could take for `ops` operations at `peak`
    and `nbytes` moved once each: the larger of the two bounds."""
    return max(ops / PEAK_FLOPS[peak], nbytes / PEAK_BYTES)
