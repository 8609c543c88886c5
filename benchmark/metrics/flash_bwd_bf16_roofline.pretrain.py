"""``flash_bwd_bf16``'s share of its roofline in the pretrain step (the
student's backward over the global and local crops)."""
from benchmark.harness.roofline import roofline_share


def read(r):
    return roofline_share(r, "flash_bwd_bf16")
