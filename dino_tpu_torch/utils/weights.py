"""When did a model's weights last change?  The staleness key of the cached
weight copies (the serving programs' bf16 copies, the int8 serving copy).

The fused optimizers write parameters in place without bumping their
version counters (seen with fused Adam on the CPU and the card), so a global
optimizer hook counts the steps per parameter, once something watches them.
"""
from __future__ import annotations

import threading

import torch.nn as nn
from torch.optim.optimizer import register_optimizer_step_post_hook
from torch.utils.weak import WeakIdKeyDictionary

# optimizer steps per parameter, counted by a global optimizer hook
_OPTIMIZER_STEPS = WeakIdKeyDictionary()
_HOOK_LOCK = threading.Lock()
_hook = None


def _count_optimizer_steps(optimizer, args, kwargs) -> None:
    for group in optimizer.param_groups:
        for p in group["params"]:
            _OPTIMIZER_STEPS[p] = _OPTIMIZER_STEPS.get(p, 0) + 1


def watch_optimizer_steps() -> None:
    """Start counting optimizer steps per parameter (idempotent)."""
    global _hook
    with _HOOK_LOCK:
        if _hook is None:
            _hook = register_optimizer_step_post_hook(_count_optimizer_steps)


def weights_key(model: nn.Module) -> tuple:
    """Identity, storage, in-place version and optimizer steps of every
    parameter and buffer: it changes when one is replaced, written in place
    (``load_state_dict``, ``copy_`` under ``no_grad``, a BatchNorm's running
    stats) or stepped by a ``torch.optim`` optimizer (once
    :func:`watch_optimizer_steps` was called).  A write through ``p.data``
    bumps no counter and is not seen."""
    return tuple((id(p), p.data_ptr(), p._version,
                  _OPTIMIZER_STEPS.get(p, 0))
                 for p in list(model.parameters()) + list(model.buffers()))
