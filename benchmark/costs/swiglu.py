"""SwiGLU's epilogue (``swiglu_kernel``, ``csrc/swiglu.cu``).

A launch over ``rows`` rows of hidden width ``hidden`` (H) reads the f32
product [a | b] (rows, 2H) and the biases (2H) in float32 once and writes
h (rows, H) in bf16 once; per output element two adds, silu (a negation,
an exponential, an add, a division) and a product: 7 operations, none on
the tensor cores.
"""


def flops(rows: int, hidden: int) -> float:
    return 7.0 * rows * hidden


def bytes_moved(rows: int, hidden: int) -> float:
    return rows * 2 * hidden * 4.0 + 2 * hidden * 4.0 + rows * hidden * 2.0
