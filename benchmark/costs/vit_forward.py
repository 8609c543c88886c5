"""Matmul FLOPs of the ViT forward and the heads, from a configuration.

A ViT forward over an s x s image (P-pixel patches, N = (s/P)^2 + 1
tokens, width D, MLP width r D) takes 2 (N - 1) (3 P^2) D for the patch
embedding and, per block, 2 N D^2 (3 + 1 + 2 r) for qkv, proj, fc1 and
fc2 (24 N D^2 at r = 4) and 4 N^2 D for QK^T and PV.  A dense head over
rows is 2 rows sum(a b) over its layers' (a, b).
"""


def vit_flops(cfg: dict, size: int) -> float:
    p, d = cfg["patch_size"], cfg["embed_dim"]
    patches = (size // p) ** 2
    n = patches + 1
    per_block = 2.0 * n * d * d * (4 + 2 * cfg["mlp_ratio"]) + 4.0 * n * n * d
    return 2.0 * patches * 3 * p * p * d + cfg["depth"] * per_block


def dense_flops(rows: int, dims) -> float:
    return 2.0 * rows * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def seg_frame_flops(cfg: dict, resolution: int) -> float:
    """One frame of the segmentation model at ``resolution``: the ViT and
    the per-patch head."""
    patches = (resolution // cfg["patch_size"]) ** 2
    return (vit_flops(cfg, resolution)
            + dense_flops(patches, cfg["head_dims"]))
