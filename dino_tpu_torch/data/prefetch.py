"""Host-side pipelining: load item k+1 while the caller works on item k.

``fit`` runs its batch loader through ``prefetched`` so the next batch is
decoded, augmented, stacked and pinned while the card runs the current
step.  One worker keeps the order, so the loader's rng stream, and with it
every pixel, is unchanged: only the overlap changes.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Tuple, TypeVar

T = TypeVar("T")


def prefetched(items: Iterable[T], load: Callable[[T], object],
               depth: int = 2) -> Iterator[Tuple[T, object]]:
    """Yield ``(item, load(item))`` in order, loading up to ``depth`` ahead
    on a background thread.

    A loader exception is re-raised at the consuming ``next()`` call (the
    step that would have used the batch), not swallowed.  Abandoning the
    iterator (break / exception in the loop body) stops the worker: the
    generator's ``finally`` sets a cancel event and drains the bounded
    queue so the blocked worker observes it and exits — no leaked threads
    across repeated calls in one process.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    cancel = threading.Event()
    _END = object()

    def worker():
        try:
            for it in items:
                if cancel.is_set():
                    return
                batch = load(it)
                while not cancel.is_set():
                    try:
                        q.put((it, batch, None), timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:  # surfaced on the consumer side
            while not cancel.is_set():
                try:
                    q.put((None, None, exc), timeout=0.1)
                    break
                except queue.Full:
                    continue
        finally:
            while not cancel.is_set():
                try:
                    q.put(_END, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, name="dt-prefetch", daemon=True)
    t.start()
    try:
        while True:
            got = q.get()
            if got is _END:
                return
            it, batch, exc = got
            if exc is not None:
                raise exc
            yield it, batch
    finally:
        cancel.set()
        while True:  # unblock a worker stuck on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
