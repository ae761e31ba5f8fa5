"""Background-prefetching data feeder (a copy of facerecon_tpu/data/feeder.py)
— SURVEY.md §3 C18.

Host-side CPU preprocessing must overlap device steps; this wraps any batch
iterator with a bounded background-thread prefetch queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional


class PrefetchIterator:
    """Iterates `source` on a background thread, `depth` batches ahead.

    close() stops the producer promptly — a daemon thread blocked in
    queue.put at interpreter shutdown aborts the process (C++ 'terminate
    called' during runtime teardown), so the producer only ever waits on
    the queue with a timeout and checks the stop flag between attempts.
    """

    def __init__(self, source: Iterable, depth: int = 2):
        self._source = iter(source)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self):
        try:
            for item in self._source:
                if not self._put(item):
                    return
        except BaseException as e:  # surfaced on the consumer thread
            self._err = e
        self._put(self._done)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._queue.get()
        if item is self._done:
            # re-enqueue the sentinel: the producer enqueues it exactly once,
            # so without this a second __next__ after exhaustion/error would
            # block forever on an empty queue
            self._queue.put(self._done)
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer and drain the queue so the thread exits."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __del__(self):  # best-effort: interpreter teardown safety
        try:
            self._stop.set()
        except Exception:
            pass


def prefetch(source: Iterable, depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(source, depth)
