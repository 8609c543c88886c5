"""The ``dino_tpu`` native checkpoint format: an npz of flattened param paths
plus the hyperparameters as embedded JSON.

The port reads and writes the same files, so a checkpoint moves between the
JAX package and this one in either direction.  The params inside are the JAX
pytree layout (``checkpointing/convert.py`` maps it to torch names).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

_HPARAMS_KEY = "__hparams_json__"
_SEP = "/"


def flatten_params(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a nested dict/list pytree of arrays to {path: ndarray}."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        out[prefix.rstrip(_SEP)] = np.asarray(tree)
        return out
    for k, v in items:
        out.update(flatten_params(v, prefix + str(k) + _SEP))
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> Any:
    """Inverse of flatten_params; integer-keyed levels become lists."""
    root: Dict[str, Any] = {}
    for path, arr in flat.items():
        node = root
        parts = path.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def materialize(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [materialize(node[str(i)]) for i in range(len(keys))]
        return {k: materialize(v) for k, v in node.items()}

    return materialize(root)


def save_checkpoint(path: str, params: Any, hparams: Dict[str, Any]) -> None:
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    flat[_HPARAMS_KEY] = np.frombuffer(
        json.dumps(hparams, sort_keys=True).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if k != _HPARAMS_KEY}
        hparams = json.loads(bytes(z[_HPARAMS_KEY].tobytes()).decode())
    return unflatten_params(flat), hparams
