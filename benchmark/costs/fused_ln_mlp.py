"""The fused LayerNorm + MLP + residual kernel (``fused_ln_mlp_kernel``).

A launch over m rows of width d with hidden width h needs 4 m d h
operations (fc1 and fc2) and moves x in and the output out once in bf16,
W1 and W2 in once in bf16, and b1, b2 and the LayerNorm's weight and bias
in once in float32.
"""


def flops(m: int, d: int, h: int) -> float:
    return 4.0 * m * d * h


def bytes_moved(m: int, d: int, h: int) -> float:
    return 2.0 * m * d * 2 + 2.0 * d * h * 2 + (h + 3 * d) * 4
