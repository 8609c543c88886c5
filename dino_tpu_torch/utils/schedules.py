"""Parameter schedules: the port of ``dino_tpu/utils/schedules.py``.

``cosine_scheduler`` is the reference's per-iteration table (linear warmup,
then cosine decay), a numpy copy of ``dino_tpu``'s, output-identical.  The
port's train steps take their scalars from the host each step, so the
counterpart of ``as_optax_schedule`` is :func:`schedule_at`, a plain
index-and-clip into the table.
"""
from __future__ import annotations

import numpy as np


def cosine_scheduler(base_value: float, final_value: float, epochs: int,
                     niter_per_ep: int, warmup_epochs: int = 0,
                     start_warmup_value: float = 0.0) -> np.ndarray:
    """Per-iteration schedule: linear warmup then cosine decay, an array of
    length epochs * niter_per_ep."""
    warmup_iters = warmup_epochs * niter_per_ep
    warmup_schedule = np.array([])
    if warmup_epochs > 0:
        warmup_schedule = np.linspace(start_warmup_value, base_value,
                                      warmup_iters)
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    schedule = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / len(iters)))
    schedule = np.concatenate((warmup_schedule, schedule))
    if len(schedule) != epochs * niter_per_ep:
        raise ValueError(f"schedule of {len(schedule)} steps, want "
                         f"{epochs * niter_per_ep}")
    return schedule


def schedule_at(schedule: np.ndarray, step: int) -> float:
    """The table's value at ``step``, the step clipped to the table's ends,
    rounded to float32: the value ``as_optax_schedule(schedule)(step)``
    gives (its table is a float32 array)."""
    return float(np.float32(schedule[int(np.clip(step, 0,
                                                 len(schedule) - 1))]))
