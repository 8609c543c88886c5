"""SwiGLU's epilogue's share of its roofline (a byte bound) in the DINOv3
960px stream: per block one launch over the batch's rows at hidden width
5,120 (``costs/swiglu.py``).  None where the trace holds no such kernel,
as in a port without the pass."""
from benchmark.harness.roofline import roofline_share


def read(r):
    return roofline_share(r, "swiglu")
