"""Background-thread batch prefetching, the port's copy of
``tpugan_tpu/data/prefetch.py``: a daemon thread fills a bounded queue, so
the host's patch sampling overlaps the card's step. A thread suffices
because the sampling's hot loops (FPS and the patch search) run in the
native library (``data/native.py``), whose ctypes calls release the GIL;
the rest of an item is a few large numpy operations. A Python loop of
small numpy calls, such as the plain FPS, would hold the GIL between its
calls and slow the step's own host work.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch_iterator(it: Iterator[T], size: int = 2) -> Iterator[T]:
    """Wrap an iterator with a background producer thread and a bounded
    queue of ``size`` ready batches."""
    q: "queue.Queue" = queue.Queue(maxsize=size)

    def producer():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()

    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        yield item
