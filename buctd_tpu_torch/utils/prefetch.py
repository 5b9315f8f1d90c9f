"""Background batch staging for the train loop.

Counterpart of buctd_tpu/utils/prefetch.py (the port's own copy; it imports
nothing of the JAX package).  ``prefetch`` runs the loader's iteration (host
planning, the host->device copy and the loader's device work) in one daemon
thread with a bounded queue, so while the card runs step N the host already
prepares batch N+1.  Depth is small: each staged batch pins its numpy copy
and its device tensors.
"""

from __future__ import annotations

import queue
import threading

_SENTINEL = object()


class _Raised:
    def __init__(self, exc):
        self.exc = exc


def prefetch(iterable, stage=None, depth: int = 2):
    """Yield ``stage(item)`` for each item, staged ahead in a background thread.

    depth <= 0 degrades to synchronous iteration (TPU.PREFETCH=0).  Exceptions
    in the loader or stage fn re-raise in the consumer; abandoning the
    generator early (break / .close()) stops the worker promptly instead of
    leaving it blocked on a full queue.
    """
    if depth <= 0:
        for item in iterable:
            yield stage(item) if stage is not None else item
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for item in iterable:
                out = stage(item) if stage is not None else item
                while not stop.is_set():
                    try:
                        q.put(out, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — propagate to the consumer
            q.put(_Raised(e))

    t = threading.Thread(target=worker, daemon=True, name="buctd-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, _Raised):
                raise item.exc
            yield item
    finally:
        stop.set()
