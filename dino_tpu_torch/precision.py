"""Matmul precision of the port's float32 paths.

Float32 means true float32: a CUDA float32 matmul may run in TF32 when
``torch.backends.cuda.matmul.allow_tf32`` is set, and a cuDNN convolution
does by default.  The fp32 predict and train paths turn both off inside the
call, the counterpart of the JAX package's ``highest`` matmul precision.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch


@contextlib.contextmanager
def true_fp32():
    """Turn TF32 off for CUDA matmuls and cuDNN inside the block, restoring
    the caller's settings after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def matmul_ctx(compute_dtype: Optional[torch.dtype]):
    """``compute_dtype=None`` (float32) runs with TF32 off; bf16 as is."""
    return true_fp32() if compute_dtype is None else contextlib.nullcontext()
