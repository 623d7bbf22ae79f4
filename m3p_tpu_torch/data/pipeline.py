"""Input pipeline: background host staging with device double-buffering
(counterpart of `m3p_tpu/data/pipeline.py`).

A daemon thread drains a numpy-batch iterator while the device runs the
previous step: it turns each batch (a dict of arrays, or a tuple of such
dicts, as the retrieval datasets' ``(t2i, i2t)`` pairs) into tensors,
integer arrays as int64.  For a CUDA device it copies each array into
pinned host memory (a copy from pageable memory would be synchronous) and
from there to the card with ``non_blocking=True`` on a side stream, and
records an event after the batch's copies.  The consumer's stream waits on
that event before the step reads the batch, and each tensor is marked as
used by that stream (``record_stream``), so the caching allocator does not
hand its memory to the side stream's next copy while the step still reads
it.  For the CPU the tensors share the arrays' memory.

Over several processes each stages its own shard of a global batch (the
`Trainer` makes the shard).  The checkpointable row loader is
`data/row_pipeline.py`:
the thread here runs ahead of the steps, so the `Trainer` counts the
batches its steps took to know the loader's position.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional, Union

import numpy as np
import torch

_DONE = object()


class DevicePrefetcher:
    """Wraps a numpy-batch iterator; yields batches of tensors on
    ``device``, ``buffer_size`` batches ahead."""

    def __init__(self, iterator: Iterator[Any], buffer_size: int = 2,
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            # the worker thread selects the card by its index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._iterator = iterator
        self._queue: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _tensor(self, value):
        if not isinstance(value, (np.ndarray, np.generic)):
            return value
        a = np.asarray(value)
        if np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int64)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not self._cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, batch):
        if isinstance(batch, dict):
            return {k: self._stage(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._stage(v) for v in batch)
        return self._tensor(batch)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            for batch in self._iterator:
                if self._stop.is_set():
                    return
                if self._cuda:
                    with torch.cuda.stream(self._stream):
                        staged = self._stage(batch)
                        ready = torch.cuda.Event()
                        ready.record(self._stream)
                else:
                    staged, ready = self._stage(batch), None
                if not self._put((staged, ready)):
                    return
        except BaseException as e:  # raised again in the consumer's thread
            self._error = e
        finally:
            self._put(_DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _DONE:
            self._queue.put(_DONE)      # later calls stop too
            if self._error is not None:
                raise self._error
            raise StopIteration
        staged, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            _record_stream(staged, stream)
        return staged

    def close(self) -> None:
        """Stop the thread and drop the batches it staged."""
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)


def _record_stream(batch, stream) -> None:
    if isinstance(batch, torch.Tensor):
        batch.record_stream(stream)
    elif isinstance(batch, dict):
        for v in batch.values():
            _record_stream(v, stream)
    elif isinstance(batch, (tuple, list)):
        for v in batch:
            _record_stream(v, stream)


# the JAX package's entry point (`prefetch_to_device(iterator, buffer_size)`)
prefetch_to_device = DevicePrefetcher
