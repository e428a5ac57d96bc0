"""Prefetching host data loader (threads) and the prefetch ring that moves
batches to the device (counterpart of the JAX package's
``datasets/loader.py``).

``DataLoader`` reads and collates batches on a thread pool, `prefetch`
batches ahead of the consumer, with the JAX loader's epoch seeding
(``default_rng(seed + epoch)``), per-process slicing and ``drop_last``.

``device_prefetch`` runs a put function (host preparation and the copy to
the device) up to `depth` items ahead of the consumer. On a CUDA device it
runs on a side stream, so the host-to-device copy of the next batch overlaps
the step that is running on the current stream; ``copy_to_device`` is the
copy (pinned staging, ``non_blocking``)."""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List

import numpy as np
import torch

_END = object()


def _tensors(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def device_prefetch(
    items: Iterable,
    put_fn: Callable[[Any], Any],
    depth: int = 2,
    device=None,
) -> Iterator:
    """Yield put_fn(item) for each item, in order, computed by a background
    thread up to `depth` items ahead; an exception of the thread is raised
    to the consumer at the point where it happened.

    On a CUDA `device`, put_fn runs with a side stream as the current stream
    and an event is recorded behind it; before the consumer gets the result,
    its current stream waits for that event and every CUDA tensor of the
    result is marked as used on that stream (``record_stream``), so the
    step never reads a half-copied batch and the caching allocator does not
    hand the batch's memory to another copy before the step is done with
    it. Elsewhere it is a plain thread queue with no CUDA call."""
    cuda = device is not None and torch.device(device).type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
    err: List[BaseException] = []
    stop = threading.Event()

    def _put(obj) -> bool:
        # bounded put so an abandoned consumer (early break, step exception)
        # can't leave this thread blocked forever holding `depth` prefetched
        # device batches
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for it in items:
                if stop.is_set():
                    return
                if cuda:
                    with torch.cuda.stream(side):
                        out = put_fn(it)
                        done = torch.cuda.Event()
                        done.record(side)
                else:
                    out, done = put_fn(it), None
                if not _put((out, done)):
                    return
        except BaseException as e:  # surfaced to the consumer
            err.append(e)
        finally:
            _put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            out, done = item
            if done is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                for x in _tensors(out):
                    if x.is_cuda:
                        x.record_stream(current)
            yield out
    finally:
        # generator close / consumer exception: release the producer and
        # drop queued batches so their device memory frees promptly
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def copy_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The batch with every numpy array and CPU tensor copied to a CUDA
    `device`: each goes through a pinned staging tensor and is copied
    without blocking the host on the current stream. Tensors already on the
    device and non-array entries pass through; on the CPU the batch is
    returned as it is. ``copy_to_device.batches`` counts the batches that
    needed a copy.

    The staging tensors come from PyTorch's pinned-memory cache, which
    records an event behind each copy that reads one and does not reuse it
    until that event has passed."""
    device = torch.device(device)
    if device.type != "cuda":
        return batch
    out, copied = {}, False
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            staged = torch.empty(value.shape, pin_memory=True,
                                 dtype=torch.from_numpy(np.empty(0, value.dtype)).dtype)
            staged.numpy()[...] = value
        elif isinstance(value, torch.Tensor) and value.device.type == "cpu":
            staged = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            staged.copy_(value)
        else:
            out[key] = value
            continue
        out[key] = staged.to(device, non_blocking=True)
        copied = True
    copy_to_device.batches += int(copied)
    return out


copy_to_device.batches = 0


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable[[List[Dict[str, Any]]], Dict[str, Any]],
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 2,
        prefetch: int = 2,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, int(num_workers))
        self.prefetch = max(1, int(prefetch))
        self.seed = int(seed)
        self.shard_id = int(shard_id)
        self.num_shards = int(num_shards)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(idx)
        # contiguous per-process shard of the (shuffled) epoch
        idx = idx[self.shard_id:: self.num_shards]
        if self.drop_last:
            n = (len(idx) // self.batch_size) * self.batch_size
            idx = idx[:n]
        return idx

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        """One pass over the (sharded) dataset as collated batches."""
        idx = self._epoch_indices(epoch)
        batches = [
            idx[i: i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        if not batches:
            return
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        err: List[BaseException] = []

        def producer():
            from concurrent.futures import ThreadPoolExecutor

            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            break
                        items = list(pool.map(self.dataset.__getitem__, b))
                        out_q.put(self.collate_fn(items))
            except BaseException as e:  # surfaced to the consumer
                err.append(e)
            finally:
                out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    if err:
                        raise err[0]
                    break
                yield item
        finally:
            stop.set()

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        """Infinite stream over repeated (re-shuffled) epochs."""
        epoch = 0
        while True:
            yielded = False
            for batch in self.epoch(epoch):
                yielded = True
                yield batch
            if not yielded:
                raise RuntimeError("DataLoader produced an empty epoch")
            epoch += 1

