"""The fused LayerNorm + MLP kernel's share of its roofline in the
960px segmentation cell (each launch over all B x N rows of a block)."""
from benchmark.harness.roofline import roofline_share


def read(r):
    return roofline_share(r, "fused_ln_mlp")
