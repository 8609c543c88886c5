"""The qkv epilogue of a RoPE attention layer (``qkv_rope_kernel``,
``csrc/qkv_rope.cu``).

A launch over ``batch`` frames of ``n`` tokens (the first ``prefix`` not
rotated) and ``heads`` heads of 64 reads qkv's f32 product (batch n, 3C),
C = 64 heads, and its bias (3C) once, the cos and sin tables ((n - prefix,
64) f32 each) once, and writes q, k and v (3 x batch x n x C) in bf16
once; per element a bias add, and per rotated element (q and k of the
patch rows) two products and a sum.
"""

HD = 64


def flops(batch: int, n: int, heads: int, prefix: int) -> float:
    c = heads * HD
    return batch * n * 3.0 * c + batch * (n - prefix) * 2.0 * c * 3.0


def bytes_moved(batch: int, n: int, heads: int, prefix: int) -> float:
    c = heads * HD
    return (batch * n * 3 * c * 4.0 + 3 * c * 4.0
            + 2 * (n - prefix) * HD * 4.0 + batch * n * 3 * c * 2.0)
