"""Where the port runs: the card by default, the CPU only when asked."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; raise if there is none (no silent CPU path)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dino_tpu_torch runs on the card by default and "
                               "found no CUDA device; pass device='cpu' to "
                               "run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def on_device(device: torch.device):
    """The context a device's launches run under: the kernels' wrappers
    launch on the tensor's device's stream from the current device, so a
    card other than the current one is made current; a no-op on the
    CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())
