"""Host data pipeline: threaded sample loading, background batch prefetch
and host-to-card copies that overlap the step.

Counterpart of ``exoground_tpu/data/pipeline.py`` (reference
utils/data_utils.py:9-93, DataLoaderFast/DataLoaderBG). Sample loading is
IO-bound (mmap'd feature reads), so a thread pool loads samples; a collate
function assembles fixed-shape numpy dicts. ``device_prefetch`` is the JAX
``device_prefetch`` (:142-160) on the card: each batch is staged in pinned
host buffers and copied with ``non_blocking`` on a side stream, and the
consumer's stream waits on the copy's event (the reference's
``non_blocking=True .to(device)``, main_egoexo4d_distributed.py:123).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from exoground_tpu_torch.data.collate import collate_dicts
from exoground_tpu_torch.data.sampling import ShardedSampler, batched


class BackgroundIterator:
    """Run an iterator on a daemon thread, buffering up to max_prefetch items
    (reference utils/data_utils.py:9-47)."""

    _SENTINEL = object()

    def __init__(self, iterable: Iterable, max_prefetch: int = 2):
        self._queue: "queue.Queue" = queue.Queue(max_prefetch)
        self._iterable = iterable
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._iterable:
                self._queue.put(item)
        except BaseException as e:  # surfaced on the consumer thread
            self._err = e
        finally:
            self._queue.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class ThreadedLoader:
    """Sampler -> parallel __getitem__ -> collate -> batch stream.

    dataset: has __len__ and __getitem__(int) -> dict of numpy arrays.
    collate: list-of-samples -> batch dict (defaults to dataset.collate_fn).
    Batch ORDER follows the sampler exactly (results are gathered in order).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler: Optional[ShardedSampler] = None,
        collate: Optional[Callable[[List[Dict]], Dict]] = None,
        num_workers: int = 8,
        drop_last: bool = True,
        prefetch_batches: int = 2,
        shuffle: bool = False,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(len(dataset), shuffle=shuffle, seed=seed)
        self.collate = collate or getattr(dataset, "collate_fn", None) or collate_dicts
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        self._pool = ThreadPoolExecutor(max_workers=self.num_workers)

    def set_epoch(self, epoch: int):
        """The sampler's epoch, and the dataset's (its per-epoch RNG)."""
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _gen(self) -> Iterator[Dict]:
        pending: "queue.Queue" = queue.Queue()
        window = self.prefetch_batches + 1

        def submit(idx_batch):
            pending.put([self._pool.submit(self.dataset.__getitem__, i) for i in idx_batch])

        batches = list(batched(iter(self.sampler), self.batch_size, self.drop_last))
        ahead = 0
        it = iter(batches)
        for _ in range(min(window, len(batches))):
            submit(next(it))
            ahead += 1
        while ahead:
            futures = pending.get()
            ahead -= 1
            nxt = next(it, None)
            if nxt is not None:
                submit(nxt)
                ahead += 1
            yield self.collate([f.result() for f in futures])

    def __iter__(self) -> Iterator[Dict]:
        return BackgroundIterator(self._gen(), max_prefetch=self.prefetch_batches)

    def close(self):
        """Stop the worker threads (queued loads are dropped)."""
        self._pool.shutdown(wait=False, cancel_futures=True)


class _Slot:
    """One batch's pinned staging buffers and the event of their last copy."""

    def __init__(self):
        self.pinned: Dict[str, torch.Tensor] = {}
        self.event: Optional[torch.cuda.Event] = None

    def stage(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self.event is not None:
            self.event.synchronize()  # the previous copy out of these buffers is done
        for k, v in arrays.items():
            buf = self.pinned.get(k)
            src = torch.from_numpy(np.ascontiguousarray(v))
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = self.pinned[k] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            buf.copy_(src)
        return {k: self.pinned[k] for k in arrays}


def device_prefetch(batches: Iterable[Dict[str, np.ndarray]], device, size: int = 2
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of numpy arrays as tensors on ``device``, copied ``size`` - 1
    batches ahead of the consumer (double buffering at ``size`` 2, as the
    JAX ``device_prefetch``).

    On a CUDA device each batch is staged in pinned host buffers (``size`` + 1
    sets, reused round robin; a set is refilled only after its last copy's
    event has completed) and copied with ``non_blocking=True`` on a side
    stream; the consumer's current stream waits on that copy's event before
    the batch is yielded, and the tensors are recorded on it for the caching
    allocator. On the CPU the arrays are wrapped as they are."""
    device = torch.device(device)
    if device.type != "cuda":
        for b in batches:
            yield {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
        return
    stream = torch.cuda.Stream(device)
    slots = [_Slot() for _ in range(size + 1)]
    buf: List = []
    for i, b in enumerate(batches):
        slot = slots[i % len(slots)]
        pinned = slot.stage(b)
        with torch.cuda.stream(stream):
            moved = {k: v.to(device, non_blocking=True) for k, v in pinned.items()}
            slot.event = torch.cuda.Event()
            slot.event.record(stream)
        buf.append((moved, slot.event))
        if len(buf) >= size:
            yield _consume(*buf.pop(0), device)
    while buf:
        yield _consume(*buf.pop(0), device)


def _consume(moved: Dict[str, torch.Tensor], event, device) -> Dict[str, torch.Tensor]:
    current = torch.cuda.current_stream(device)
    current.wait_event(event)
    for t in moved.values():
        t.record_stream(current)
    return moved
