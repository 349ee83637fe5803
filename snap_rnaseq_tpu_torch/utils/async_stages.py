"""Decoupled reader / writer stages for the host pipelines.

Role of reference SNAPLib/ReadSupplierQueue.{h,cpp} (reader threads feeding
aligner threads through bounded queues of 40,000-read elements,
ReadSupplierQueue.h:49-198) and SNAPLib/BufferedAsync.h:25-48 +
DataWriter.h (async buffered output): here the ALIGNER is the device, so
the host splits into

  reader thread   parse + clip + filter the input stream into a bounded
                  queue (file I/O and byte fiddling off the main thread);
  main thread     bucket by read length, dispatch fixed-shape batches to
                  the device (JAX dispatch must stay on one thread);
  writer thread   device-result fetch (np.asarray blocks until the batch
                  is ready — that wait moves off the main thread), record
                  formatting, builder/output writes, stats.

The writer owns ALL mutation of the stats object and the output builder;
the main thread submits closures that run in submission order, so
per-read code needs no locks (single-writer design, like the reference's
one-BaseAligner-per-thread rule, BaseAligner.h:19-20).
"""
from __future__ import annotations

import queue
import threading

_DONE = object()


class PrefetchIterator:
    """Background-thread prefetch of an iterable into a bounded queue."""

    def __init__(self, iterable, depth: int = 8192):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._exc = None

        def pump():
            try:
                for item in iterable:
                    self._q.put(item)
            except BaseException as e:       # noqa: BLE001 — re-raised below
                self._exc = e
            finally:
                self._q.put(_DONE)

        self._thread = threading.Thread(target=pump, daemon=True,
                                        name="snap-reader")
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _DONE:
                if self._exc is not None:
                    raise self._exc
                return
            yield item


class OrderedWorker:
    """Single worker thread executing submitted closures in order.

    submit() blocks when `depth` closures are outstanding — with batch
    drains this bounds device results in flight (the double-buffering the
    synchronous pipelines did with a `pending` list) and applies
    backpressure to the reader (the reference's MaxImbalance throttle,
    ReadSupplierQueue.h:126-128).
    """

    def __init__(self, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._exc = None

        def loop():
            while True:
                item = self._q.get()
                if item is _DONE:
                    return
                if self._exc is None:
                    fn, args = item
                    try:
                        fn(*args)
                    except BaseException as e:   # noqa: BLE001
                        self._exc = e

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="snap-writer")
        self._thread.start()

    def submit(self, fn, *args) -> None:
        if self._exc is not None:
            raise self._exc
        self._q.put((fn, args))

    def close(self) -> None:
        """Drain the queue, join the thread, re-raise any stage error."""
        self._q.put(_DONE)
        self._thread.join()
        if self._exc is not None:
            raise self._exc
