"""Host-side input prefetch (counterpart of ``ragraph_tpu/train/prefetch.py``).

A background thread runs the wrapped iterator a few items ahead of the
consumer, so the trainer's batch making (the shuffle and the C++ negative
sampler, which releases the interpreter lock) overlaps the device's step.
The items, and their order, are those of the wrapped iterator: the producer
is the same generator, only ahead. The thread makes host data only; copies
to the device stay with the consumer. Under a profiler recording the
consumer's wait is span ``feed.wait``, and counters ``feed.items`` and
``feed.empty`` count the items taken and those the queue did not yet hold.
"""

from __future__ import annotations

import queue
import threading

from ragraph_tpu_torch.train.profiling import count, span

_END = object()


class PrefetchIterator:
    """Iterate ``iterable`` through a queue of ``depth`` items filled by a
    background thread. An exception of the producer is raised to the
    consumer where the item would have come. :meth:`close` (or leaving a
    ``with`` block) stops the producer at its next item."""

    def __init__(self, iterable, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._done = False
        self._thread = threading.Thread(target=self._work, args=(iterable,),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _work(self, iterable) -> None:
        try:
            for item in iterable:
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 -- raised by __next__
            self._err = e
        self._put(_END)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        with span("feed.wait"):
            try:
                item, empty = self._queue.get_nowait(), 0
            except queue.Empty:
                item, empty = self._queue.get(), 1
        if item is _END:
            self._done = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        count("feed.items")
        count("feed.empty", empty)
        return item

    def close(self) -> None:
        """Stop the producer and wait for its thread."""
        self._stop.set()
        self._done = True
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch(iterable, depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(iterable, depth=depth)
