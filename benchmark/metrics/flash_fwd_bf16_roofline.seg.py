"""``flash_fwd_bf16``'s share of its roofline in the segmentation cells
(each launch over batch x heads rows of the frame's N tokens)."""
from benchmark.harness.roofline import roofline_share


def read(r):
    return roofline_share(r, "flash_fwd_bf16")
