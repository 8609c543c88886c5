"""PyTorch/CUDA port of ``dino_tpu``: DINO ViT coarse segmentation on an
NVIDIA H100.

The package mirrors ``dino_tpu/`` module by module.  Plain tensor code is
PyTorch; every Pallas TPU kernel has a hand-written CUDA C++ counterpart for
``sm_90a`` (``csrc/``), built with nvcc at first use and bound with ctypes
(``ops/_build.py``).  Tensors on the CPU take each kernel's plain PyTorch
version, which is what the CPU tests compare.  Collectives go through
``torch.distributed`` (``parallel/``).

The package imports neither ``jax`` nor ``dino_tpu``.
"""
from dino_tpu_torch.api import DINOSeg
from dino_tpu_torch.serving import export_predict, load_exported_predict

__all__ = ["DINOSeg", "export_predict", "load_exported_predict"]
