"""Asynchronous checkpoint writes: serialization off the train loop.

``AsyncCheckpointer`` splits a save in two.  The copy of every tensor to
host memory happens inline in ``save*()``: the train loop updates its
parameters and optimizer state in place, so a tensor handed to a
background thread could change under it.  Serializing the ``.npz`` and the
atomic rename run on one writer thread, in submission order.  A failed
write is raised at the next ``save*()`` / ``wait()``; ``close()`` drains
the queue and joins the thread.
"""
from __future__ import annotations

import atexit
import queue
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from dino_tpu_torch.checkpointing import resume as ck_resume


def _snapshot(tree: Any) -> Any:
    """Tensors (on any device) -> host numpy copies, through dicts and
    lists."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_snapshot(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy().copy()
    return np.array(tree)


class AsyncCheckpointer:
    def __init__(self, name: str = "ckpt-writer"):
        self._q: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._closed = False
        self._worker = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._worker.start()
        atexit.register(self.wait)

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            fn, args = job
            try:
                fn(*args)
            except BaseException as e:  # raised at the next save/wait
                with self._lock:
                    self._error = e
            finally:
                self._q.task_done()

    def _check(self) -> None:
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err

    def save_train_state(self, path: str, state: Dict[str, Any],
                         run_variables: Optional[Dict[str, Any]] = None
                         ) -> None:
        """Async twin of ``resume.save_train_state`` (same file)."""
        self._check()
        self._q.put((ck_resume.save_train_state,
                     (path, _snapshot(state), dict(run_variables or {}))))

    def wait(self) -> None:
        """Block until every queued write has landed; raise a failure."""
        self._q.join()
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err

    def close(self) -> None:
        if self._closed:
            return
        self.wait()
        self._closed = True
        self._q.put(None)
        self._worker.join()
        atexit.unregister(self.wait)
