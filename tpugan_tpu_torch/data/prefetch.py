"""Background-thread batch prefetching, the port's copy of
``tpugan_tpu/data/prefetch.py``: a daemon thread fills a bounded queue, so
the host's patch sampling overlaps the card's step (numpy and scipy release
the GIL for the heavy parts, so a thread suffices).
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
