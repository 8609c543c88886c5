"""The segmentation forward shared by predict and (later) training.

Only ``seg_forward`` is ported so far; the training step is ROADMAP
"Modules to port" item 4.
"""
from __future__ import annotations

from typing import Optional

import torch

from dino_tpu_torch.models.heads import head_apply
from dino_tpu_torch.models.vit import ViTConfig, VisionTransformer, vit_forward
from dino_tpu_torch.ops.preprocess import normalize_imagenet


def seg_forward(vit: VisionTransformer, head: torch.nn.Module, cfg: ViTConfig,
                head_type: str, images_u8: Optional[torch.Tensor] = None,
                pre_normalized: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """uint8 (B,res,res,3) -> (B*N_patches, n_classes) log-probs.

    Backbone -> drop CLS -> fold patches onto the batch axis -> per-patch
    head.  Normalization runs here unless a pre-normalized tensor is given
    (the predict path resizes and normalizes upstream).
    ``compute_dtype=torch.bfloat16`` runs the matmuls in bf16; LayerNorm,
    softmax and the final log_softmax stay float32.
    """
    x = (pre_normalized if pre_normalized is not None
         else normalize_imagenet(images_u8))
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    tokens = vit_forward(vit, x, cfg)
    feats = tokens[:, 1:, :].reshape(-1, tokens.shape[-1])
    return head_apply(head_type, head, feats)
