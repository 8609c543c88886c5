"""Mid-training resume: save and restore the whole train state.

One ``.npz`` holds named trees of arrays (the modules' parameters in the
``dino_tpu`` layout, ``checkpointing/convert.py:to_jax_params``, and the
optimizer's per-parameter state) flattened as ``checkpointing/io.py`` does,
plus the loop's scalars (epoch, best metric), so an interrupted fit
continues where it stopped.  The optimizer state is ``torch.optim``'s, so a
resume file is read by this package only; the best checkpoints
(``io.save_checkpoint``) are read by both packages.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from dino_tpu_torch.checkpointing.io import flatten_params, unflatten_params

_SENTINEL_NONE = "__none__"


def save_train_state(path: str, state: Dict[str, Any],
                     run_variables: Optional[Dict[str, Any]] = None) -> None:
    """``state``: named trees of host arrays; ``run_variables``: scalars.
    Written to a temporary name and renamed, so a crash never leaves a torn
    file."""
    flat = {"state/" + k: np.asarray(v)
            for k, v in flatten_params(state).items()}
    for k, v in (run_variables or {}).items():
        flat["run/" + k] = np.asarray(v if v is not None else _SENTINEL_NONE)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def restart_from_checkpoint(path: str, run_variables: Optional[Dict] = None,
                            **trees) -> Dict[str, Any]:
    """Restore the named trees and fill ``run_variables`` in place.  Returns
    {name: restored tree}; a missing file leaves the inputs as they are."""
    out = dict(trees)
    if not os.path.isfile(path):
        print(f"Pre-trained weights not found at {path}")
        return out
    print(f"Found checkpoint at {path}")
    with np.load(path, allow_pickle=False) as z:
        state_flat = {k[len("state/"):]: z[k] for k in z.files
                      if k.startswith("state/")}
        run_flat = {k[len("run/"):]: z[k] for k in z.files
                    if k.startswith("run/")}
    state = unflatten_params(state_flat)
    for name in trees:
        if name in state:
            out[name] = state[name]
            print(f"=> loaded '{name}' from checkpoint: '{path}'")
        else:
            print(f"=> failed to load '{name}' from checkpoint: '{path}'")
    if run_variables is not None:
        for k in list(run_variables):
            if k in run_flat:
                v = run_flat[k]
                if v.dtype.kind in "US":
                    run_variables[k] = (None if str(v) == _SENTINEL_NONE
                                        else str(v))
                else:
                    run_variables[k] = v.item() if v.ndim == 0 else v
    return out


def optimizer_arrays(opt: torch.optim.Optimizer) -> Dict[str, Dict[str, Any]]:
    """The optimizer's per-parameter state as {index: {name: tensor}} (its
    hyperparameters are rebuilt by whoever builds the optimizer)."""
    return {str(i): {k: v.detach() if torch.is_tensor(v) else np.asarray(v)
                     for k, v in s.items()}
            for i, s in opt.state_dict()["state"].items()}


def load_optimizer_arrays(opt: torch.optim.Optimizer,
                          arrays: Dict[str, Dict[str, Any]]) -> None:
    """Inverse of :func:`optimizer_arrays`: load restored host arrays into
    ``opt`` (``torch.optim`` places each on its parameter's device)."""
    sd = opt.state_dict()
    # io.unflatten_params turns the integer-keyed level back into a list
    items = arrays.items() if isinstance(arrays, dict) else enumerate(arrays)
    sd["state"] = {int(i): {k: torch.from_numpy(np.array(v))
                            for k, v in s.items()}
                   for i, s in items}
    opt.load_state_dict(sd)
