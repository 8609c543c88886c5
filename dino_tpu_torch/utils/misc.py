"""Small utilities: the counterpart of ``dino_tpu/utils/misc.py`` (the
reference's utils.py: accuracy :502-509, fix_random_seeds :215-221,
get_sha :403-420, bool_flag :201-212, has_batchnorms :646-651)."""
from __future__ import annotations

import argparse
import os
import random
import subprocess
from typing import Mapping, Sequence, Union

import numpy as np
import torch
import torch.nn as nn


def accuracy(output, target, topk: Sequence[int] = (1,)):
    """Top-k accuracy (percent) of logits ``output`` (B, C) against integer
    ``target`` (B,); ties rank as ``dino_tpu``'s descending ``argsort``
    ranks them."""
    output = torch.as_tensor(np.asarray(output))
    target = torch.as_tensor(np.asarray(target))
    maxk = max(topk)
    idx = torch.argsort(output, dim=1, stable=True).flip(1)[:, :maxk]
    correct = idx == target[:, None]
    return [float(correct[:, :k].sum()) * 100.0 / target.shape[0]
            for k in topk]


def fix_random_seeds(seed: int = 31) -> torch.Generator:
    """Seed torch (every card too), numpy and ``random``, and return a
    ``torch.Generator`` seeded with ``seed``: the port's counterpart of the
    JAX PRNG key ``dino_tpu`` returns, passed to the code that draws
    (``init_vit_params``, ``init_head``, ...)."""
    torch.manual_seed(seed)
    np.random.seed(seed)
    random.seed(seed)
    return torch.Generator().manual_seed(seed)


def get_sha() -> str:
    """Repo provenance string: sha, diff status, branch."""
    cwd = os.path.dirname(os.path.abspath(__file__))

    def _run(cmd):
        return subprocess.check_output(cmd, cwd=cwd).decode("ascii").strip()

    sha, diff, branch = "N/A", "clean", "N/A"
    try:
        sha = _run(["git", "rev-parse", "HEAD"])
        subprocess.check_output(["git", "diff"], cwd=cwd)
        diff = _run(["git", "diff-index", "HEAD"])
        diff = "has uncommitted changes" if diff else "clean"
        branch = _run(["git", "rev-parse", "--abbrev-ref", "HEAD"])
    except (OSError, subprocess.CalledProcessError):
        pass
    return f"sha: {sha}, status: {diff}, branch: {branch}"


def bool_flag(s: str) -> bool:
    """argparse type for boolean flags (reference utils.py:201-212)."""
    if s.lower() in {"off", "false", "0"}:
        return False
    if s.lower() in {"on", "true", "1"}:
        return True
    raise argparse.ArgumentTypeError("invalid value for a boolean flag")


def has_batchnorms(params: Union[nn.Module, Mapping[str, object]]) -> bool:
    """Whether a model holds batch-norm state: an ``nn.Module`` with a
    BatchNorm layer, or a state dict with a layer's ``running_mean`` and
    ``running_var``.  The ViT has none; the cnn1/cnn2 ResNets do."""
    if isinstance(params, nn.Module):
        return any(isinstance(m, nn.modules.batchnorm._BatchNorm)
                   for m in params.modules())
    keys = set(params)
    return any(k.endswith(".running_mean")
               and k[:-len("running_mean")] + "running_var" in keys
               for k in keys)
