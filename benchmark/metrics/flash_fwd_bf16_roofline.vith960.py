"""``flash_fwd_bf16``'s share of its roofline in the DINOv3 960px stream
(per block one launch over batch x 20 heads of the frame's 3,605 tokens at
head size 64)."""
from benchmark.harness.roofline import roofline_share


def read(r):
    return roofline_share(r, "flash_fwd_bf16")
