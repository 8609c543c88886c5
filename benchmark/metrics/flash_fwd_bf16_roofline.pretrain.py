"""``flash_fwd_bf16``'s share of its roofline in the pretrain step: the
student's launches over the global (N 785) and local (N 145) crops, with
the row lse kept for the backward, and the teacher's over the globals."""
from benchmark.harness.roofline import roofline_share


def read(r):
    return roofline_share(r, "flash_fwd_bf16")
