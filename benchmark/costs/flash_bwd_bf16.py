"""The bf16 flash-attention backward (``flash_bwd_bf16``).

A launch over bh rows of n tokens, head size hd, needs 10 n^2 hd bh
operations (S recomputed, dV, dP, dQ and dK: five products of two each)
and moves Q, K, V and dO in once in bf16, the row lse and D = rowsum(dO *
O) in once in float32, and dQ, dK and dV out once in float32.
"""


def flops(bh: int, n: int, hd: int) -> float:
    return 10.0 * n * n * hd * bh


def bytes_moved(bh: int, n: int, hd: int) -> float:
    return 4.0 * bh * n * hd * 2 + 2.0 * bh * n * 4 + 3.0 * bh * n * hd * 4
