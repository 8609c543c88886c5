"""Matmul FLOPs of the DINOv3 segmentation model's forward, from a
configuration.

Over an s x s frame (P-pixel patches, HW = (s/P)^2 patches, N = HW + 1 +
storage tokens, width D, SwiGLU width H): the patch embedding 2 HW (3 P^2)
D; per block 2 N D (3D + D) for qkv and proj, 2 N D (2H) for w1 and w2 and
2 N H D for w3, 4 N^2 D for QK^T and PV; the per-patch head 2 HW sum(a b)
over its layers.  At the published widths and 960px (N 3,605): 189 GFLOP of
linear work and 66.5 GFLOP of attention a block, 8.2 TFLOP a frame.
"""


def seg_frame_flops(cfg: dict, resolution: int) -> float:
    p, d, h = cfg["patch_size"], cfg["embed_dim"], cfg["ffn_hidden"]
    patches = (resolution // p) ** 2
    n = patches + 1 + cfg["n_storage_tokens"]
    per_block = 2.0 * n * d * (4 * d + 3 * h) + 4.0 * n * n * d
    dims = cfg["head_dims"]
    head = 2.0 * patches * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return 2.0 * patches * 3 * p * p * d + cfg["depth"] * per_block + head
