"""The bf16 flash-attention forward (``flash_fwd_bf16``).

A launch over bh = batch x heads rows of n tokens and head size hd needs
4 n^2 hd bh operations (QK^T and PV, two each a multiply-add) and moves
Q, K and V in once and O out once in bf16, and with ``lse`` the row
log-sum-exp out in float32.
"""


def flops(bh: int, n: int, hd: int, lse: bool = False) -> float:
    return 4.0 * n * n * hd * bh


def bytes_moved(bh: int, n: int, hd: int, lse: bool = False) -> float:
    return 4.0 * bh * n * hd * 2 + (bh * n * 4 if lse else 0)
