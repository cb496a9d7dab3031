"""Background-thread batch prefetching (port of
``tf2_gnn_tpu/data/prefetch.py``, the same code with its buffer size
fixed).

Equivalent of dpu-utils' ``DoubleBufferedIterator`` used by the reference's
data pipeline (tf2_gnn/data/graph_dataset.py:292-297): batch assembly (pack +
pad, the host-side hot loop) runs in a worker thread while the previous batch
trains on device. A bounded queue provides the double buffering.
"""
import queue
import threading
from typing import Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()

# How far ahead the producer runs: the reference's ``.prefetch(3)`` tf.data
# setting (cli_utils/training_utils.py:114-115).
BUFFER_SIZE = 3


class PrefetchIterator:
    """Wrap an iterator; items are produced ahead of time in a daemon thread.

    The producer runs at most ``BUFFER_SIZE`` items ahead. Exceptions in
    the producer are re-raised in the consumer. ``close()`` (also called on
    garbage collection) unblocks and terminates the producer early, so
    partially consumed iterators do not pin threads.
    """

    def __init__(self, source: Iterator[T]):
        self._queue: "queue.Queue" = queue.Queue(maxsize=BUFFER_SIZE)
        self._error = None
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(source,), daemon=True
        )
        self._thread.start()

    def _produce(self, source):
        try:
            for item in source:
                while not self._closed.is_set():
                    try:
                        self._queue.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._closed.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            self._error = e
        finally:
            try:
                self._queue.put_nowait(_SENTINEL)
            except queue.Full:
                pass

    def close(self) -> None:
        self._closed.set()

    def __del__(self):  # pragma: no cover - GC timing dependent
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._queue.get(timeout=0.2)
                break
            except queue.Empty:
                if self._closed.is_set() or not self._thread.is_alive():
                    # Producer finished; drain whatever made it into the queue.
                    try:
                        item = self._queue.get_nowait()
                        break
                    except queue.Empty:
                        # The sentinel is dropped when the queue is full at
                        # producer exit; the error must still surface here.
                        if self._error is not None:
                            raise self._error
                        raise StopIteration from None
        if item is _SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def prefetch(source: Iterator[T]) -> Iterator[T]:
    return PrefetchIterator(source)
