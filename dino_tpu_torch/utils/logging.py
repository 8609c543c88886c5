"""Experiment loggers and device-memory telemetry.

The default sink is a JSONL file (offline, greppable); a Comet adapter
engages only when ``comet_ml`` is importable and a tag is given (it is
imported inside the adapter, never by this module).  ``hbm_stats`` reads the
card's memory counters for the per-epoch metrics of ``fit``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch


class JSONLLogger:
    """Append-only JSONL metrics log with the Comet adapter's methods."""

    def __init__(self, path: str, tag: Optional[str] = None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.tag = tag
        self._write({"event": "start", "tag": tag})

    def _write(self, record: Dict[str, Any]) -> None:
        record = dict(record, ts=time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        self._write({"event": "metrics", "step": step, **metrics})

    def log_params(self, params: Dict[str, Any]) -> None:
        self._write({"event": "params", **params})

    def log_confusion_matrix(self, cm, title: str, step: int,
                             labels=None, file_name=None) -> None:
        self._write({"event": "confusion_matrix", "title": title,
                     "step": step, "labels": list(labels) if labels else None,
                     "file_name": file_name,
                     "matrix": [list(map(int, row)) for row in cm]})

    def log_asset(self, path: str) -> None:
        self._write({"event": "asset", "path": os.path.abspath(path)})


class CometAdapter:  # pragma: no cover - needs comet_ml and the network
    def __init__(self, tag: str, project: str = "duck"):
        import comet_ml
        self.exp = comet_ml.Experiment(
            api_key=os.environ.get("COMET_API_KEY"), project_name=project)
        self.exp.add_tag(tag)

    def log_metrics(self, metrics, step):
        self.exp.log_metrics(metrics, step=step)

    def log_params(self, params):
        self.exp.log_parameters(params)

    def log_confusion_matrix(self, cm, title, step, labels=None,
                             file_name=None):
        self.exp.log_confusion_matrix(
            matrix=cm, title=title, labels=labels,
            file_name=file_name or f"{title}_epoch_{step}.json")

    def log_asset(self, path):
        self.exp.log_asset(path)


def make_logger(tag: Optional[str], write_path: str,
                params: Optional[Dict[str, Any]] = None):
    """Comet when it is importable and a tag is given, else JSONL under
    ``write_path``."""
    logger = None
    if tag is not None:
        try:
            logger = CometAdapter(tag)
        except Exception:  # no comet_ml, no key or no network: log locally
            logger = None
    if logger is None:
        logger = JSONLLogger(os.path.join(write_path, "metrics.jsonl"),
                             tag=tag)
    if params:
        logger.log_params(params)
    return logger


def hbm_stats(device=None) -> Optional[dict]:
    """The card's memory counters: ``{"bytes_in_use", "peak_bytes_in_use",
    "bytes_limit", "utilization"}`` (utilization = in use / limit, the
    peak over the process's life), or None for a CPU device.  The port's
    ``dino_tpu/utils/profiling.py:hbm_stats``, from PyTorch's allocator."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    limit = torch.cuda.get_device_properties(device).total_memory
    in_use = stats.get("allocated_bytes.all.current", 0)
    return {"bytes_in_use": int(in_use),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               in_use)),
            "bytes_limit": int(limit),
            "utilization": float(in_use / limit) if limit else 0.0}
