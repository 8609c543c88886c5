"""The qkv epilogue's (bias, RoPE rotation, rounding, head-major layout)
share of its roofline (a byte bound) in the DINOv3 960px stream: per block
one launch over the batch's tokens (``costs/qkv_rope.py``).  None where
the trace holds no such kernel."""
from benchmark.harness.roofline import roofline_share


def read(r):
    return roofline_share(r, "qkv_rope")
