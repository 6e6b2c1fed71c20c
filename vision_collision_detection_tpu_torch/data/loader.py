"""Host-side batch loader and the device feed.

Counterpart of ``vision_collision_detection_tpu/data/loader.py``. The
loader is a thread pool in place of the reference's DataLoader worker
processes and DistributedSampler: the C++ decoder releases the GIL, so
threads decode in parallel. Its sharding is DistributedSampler's: an
epoch-seeded permutation, wrap-padded to a multiple of ``num_shards``,
round-robin shard slices, so every shard sees as many samples.

``device_feed`` takes the place of the JAX package's ``device_prefetch``:
a producer thread copies the loader's numpy batches into pinned host
buffers and from there to the card on a side CUDA stream, while the
caller computes on the previous batch. Its consumer's wait for a batch is
the span ``vcd.feed.wait``; what its producer thread does, which a trace
of the consumer's thread does not show, is counted on ``device_feed``'s
attributes (its docstring).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from vision_collision_detection_tpu_torch.obs.profiling import annotate


def collate(samples) -> dict:
    return {
        "frames": np.stack([s["frames"] for s in samples]),
        "sensor": np.stack([s["sensor"] for s in samples]),
        "target": np.asarray([s["target"] for s in samples], dtype=np.int64),
        "id": [s["id"] for s in samples],
        "error": np.asarray([s["error"] for s in samples], dtype=bool),
        "pad": np.asarray([s.get("pad", False) for s in samples], dtype=bool),
    }


def _pad_collated(batch: dict, target: int) -> dict:
    """Grow a collated batch to `target` rows with masked dummy samples."""
    n = len(batch["id"])
    k = target - n
    out = dict(batch)
    for key in ("frames", "sensor", "target"):
        pad_row = np.zeros_like(batch[key][:1])
        out[key] = np.concatenate([batch[key]] + [pad_row] * k)
    out["id"] = list(batch["id"]) + ["__pad__"] * k
    out["error"] = np.concatenate([batch["error"], np.ones(k, bool)])
    out["pad"] = np.concatenate([batch["pad"], np.ones(k, bool)])
    return out


def _pad_sample(template: dict) -> dict:
    """Shape-compatible dummy sample; masked out of loss/metrics downstream."""
    return {
        "frames": np.zeros_like(template["frames"]),
        "sensor": np.zeros_like(template["sensor"]),
        "target": np.int64(0),
        "id": "__pad__",
        "error": True,
        "pad": True,
    }


class ClipLoader:
    """Iterable over fixed-shape numpy batches with epoch-seeded shuffling."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        prefetch_batches: int = 2,
        seed: int = 42,
        num_shards: int = 1,
        shard_index: int = 0,
        pad_partial: bool = False,
        mask_wrap: bool = False,
    ):
        """pad_partial: fill the trailing partial batch with masked dummy
        samples so every batch has identical shape — required when batches are
        sharded over devices (static shapes), and the same pad+mask trick
        the reference uses for its eval all_gather."""
        if num_shards < 1 or not (0 <= shard_index < num_shards):
            raise ValueError("bad shard spec")
        self.pad_partial = pad_partial
        # mask_wrap: flag the shard-equalizing wrap duplicates as pads so
        # evaluation masks + trims them (gathered metrics must not double-
        # count; the reference gen-3b trims by true sizes). Training keeps
        # them unmasked — DistributedSampler's duplicates ARE trained on.
        self.mask_wrap = mask_wrap
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle per epoch (the reference's train_sampler.set_epoch)."""
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        return self._indices_and_wrap()[0]

    def _indices_and_wrap(self):
        """→ (indices, wrap_flags): wrap rows are the DistributedSampler-
        style duplicates appended so every shard gets an equal count. They
        are flagged so evaluation can mask and trim them — otherwise
        gathered metrics double-count the wrapped samples (the reference's
        gen-3b trims by true sizes; flag+trim is the static-shape
        equivalent)."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            idx = rng.permutation(idx)
        wrap = np.zeros(len(idx), bool)
        if self.num_shards > 1:
            target = -(-n // self.num_shards) * self.num_shards
            if target > n:
                idx = np.concatenate([idx, idx[: target - n]])
                wrap = np.concatenate(
                    [wrap, np.ones(target - n, bool)])
            idx = idx[self.shard_index :: self.num_shards]
            wrap = wrap[self.shard_index :: self.num_shards]
        return idx, wrap

    def _batches(self):
        idx, wrap = self._indices_and_wrap()
        n = len(idx)
        batches = []
        for i in range(0, n, self.batch_size):
            b = idx[i : i + self.batch_size]
            if len(b) < self.batch_size and self.drop_last:
                continue
            batches.append((b, wrap[i : i + self.batch_size]))
        return batches

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        if getattr(self.dataset, "supports_batch", False):
            yield from self._iter_native_batches()
        else:
            yield from self._iter_per_sample()

    def _iter_native_batches(self) -> Iterator[dict]:
        """Whole-batch fetches through the C++ batch decoder (its internal
        thread pool does the parallelism; Python only pipelines batches)."""
        batches = self._batches()
        if not batches:
            return
        ex = ThreadPoolExecutor(max_workers=2)

        def fetch(b: int):
            # num_threads=0 → the C pool sizes itself to the hardware
            # (num_workers Python threads would oversubscribe small hosts)
            return self.dataset.get_batch(batches[b][0], self.epoch,
                                          num_threads=0)

        futures: dict = {}
        try:
            depth = min(self.prefetch_batches + 1, len(batches))
            for b in range(depth):
                futures[b] = ex.submit(fetch, b)
            for b in range(len(batches)):
                if b + depth < len(batches):
                    futures[b + depth] = ex.submit(fetch, b + depth)
                batch = futures.pop(b).result()
                n = len(batch["id"])
                wrap = batches[b][1]
                if self.mask_wrap and wrap.any():
                    batch["pad"] = np.asarray(batch["pad"], bool) | wrap[:n]
                if self.pad_partial and n < self.batch_size:
                    batch = _pad_collated(batch, self.batch_size)
                yield batch
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def _iter_per_sample(self) -> Iterator[dict]:
        batches = self._batches()
        if not batches:
            return
        ex = ThreadPoolExecutor(max_workers=self.num_workers)
        futures: dict = {}

        def submit(b: int):
            for k, i in enumerate(batches[b][0]):
                futures[(b, k)] = ex.submit(self.dataset.get, int(i),
                                            self.epoch)

        try:
            depth = min(self.prefetch_batches + 1, len(batches))
            for b in range(depth):
                submit(b)
            for b in range(len(batches)):
                if b + depth < len(batches):
                    submit(b + depth)
                samples = [futures.pop((b, k)).result()
                           for k in range(len(batches[b][0]))]
                if self.mask_wrap:
                    for k, w in enumerate(batches[b][1]):
                        if w:  # shard-equalizing duplicate → masked pad
                            samples[k] = dict(samples[k], pad=True)
                if self.pad_partial and len(samples) < self.batch_size:
                    samples += [_pad_sample(samples[0])] * (
                        self.batch_size - len(samples)
                    )
                yield collate(samples)
        finally:
            ex.shutdown(wait=False, cancel_futures=True)


def _produce(iterator: Iterable, stage: Callable, depth: int) -> Iterator:
    """Run ``stage(batch)`` over ``iterator`` on a producer thread, at most
    ``depth`` results ahead of the consumer, and yield the results in
    order. An exception in the producer re-raises here. When the consumer
    stops early, the ``finally`` stops the producer, drains the queue and
    joins the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    done = object()

    def offer(item) -> bool:
        """Blocking put that gives up when the consumer went away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            it = iter(iterator)
            while True:
                t0 = time.perf_counter_ns()
                batch = next(it, done)
                _count(next_ns=time.perf_counter_ns() - t0)
                if batch is done:
                    break
                if stop.is_set() or not offer(stage(batch)):
                    return
            offer(done)
        except BaseException as e:  # handed to the consumer, which raises it
            offer(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:  # a loader's generator shuts its pool down
                close()

    t = threading.Thread(target=producer, name="device_feed", daemon=True)
    t.start()
    try:
        while True:
            with annotate("vcd.feed.wait"):
                item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        t.join()


_counts = threading.Lock()


def _count(**more: int) -> None:
    """Add to ``device_feed``'s counters. Feeds run on several threads at
    once (a training epoch's and a mini-validation's producers), so each
    addition holds a lock."""
    with _counts:
        for k, v in more.items():
            setattr(device_feed, k, getattr(device_feed, k) + v)


def _wait_for_copy(event: "torch.cuda.Event") -> None:
    """Before a pinned buffer is refilled: its last copy must be done."""
    event.synchronize()


def _copy_to(buf: torch.Tensor, device) -> torch.Tensor:
    """The host→device copy of a pinned buffer, issued on the current
    stream (the feed's side stream) without waiting for it."""
    return buf.to(device, non_blocking=True)


def _hand_over(out: dict, keys, event: "torch.cuda.Event", device) -> dict:
    """Before the consumer sees a batch: its stream waits for the copy, and
    the copied tensors are marked as used on that stream (they were
    allocated on the side stream)."""
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    for k in keys:
        out[k].record_stream(stream)
    return out


def device_feed(iterator: Iterable[dict], device, depth: int = 2,
                keys=("frames", "sensor", "target")) -> Iterator[dict]:
    """Yield the loader's batches with ``keys`` as tensors on ``device``.

    On a CUDA device a producer thread keeps, per key, a ring of
    ``depth + 1`` pinned host buffers. It copies each numpy batch into the
    next buffer, once that buffer's last host→device copy has completed,
    then issues ``.to(device, non_blocking=True)`` on a side CUDA stream and
    records an event. The consumer's current stream waits on that event
    before the batch is yielded, so the caller's work queues behind the
    copy, and the copy overlaps the caller's work on the previous batch.
    Errors in the producer re-raise here; breaking out early stops it.

    On a CPU device there is no thread and nothing to overlap: each key
    becomes ``torch.as_tensor`` of the batch's array, in the caller's
    thread.

    The caller's wait for each batch is the span ``vcd.feed.wait`` (on the
    CUDA path the producer's queue, on the CPU path the loader). The
    counters, attributes of this function read as the ops' launch counters
    are: ``feeds`` (feeds started), ``batches`` (batches yielded, both
    paths) and, from the CUDA path's producer thread, ``next_ns`` (its
    wait on the loader), ``stage_ns`` (the slot's last-copy wait, the
    pinned allocations, the copy into pinned memory and the copy's issue),
    ``pin_allocs`` and ``pinned_bytes`` (the pinned buffers allocated: a
    feed builds its ring anew).
    """
    _count(feeds=1)
    device = torch.device(device)
    if device.type != "cuda":
        it = iter(iterator)
        while True:
            with annotate("vcd.feed.wait"):
                batch = next(it, None)
            if batch is None:
                return
            out = dict(batch)
            for k in keys:
                out[k] = torch.as_tensor(batch[k])
            _count(batches=1)
            yield out

    side = torch.cuda.Stream(device)
    slots = depth + 1
    pinned = [dict() for _ in range(slots)]
    events = [None] * slots
    count = 0

    def stage(batch):
        nonlocal count
        t0 = time.perf_counter_ns()
        allocs = nbytes = 0
        i = count % slots
        count += 1
        if events[i] is not None:
            _wait_for_copy(events[i])
        out = dict(batch)
        with torch.cuda.stream(side):
            for k in keys:
                src = torch.as_tensor(np.ascontiguousarray(batch[k]))
                buf = pinned[i].get(k)
                if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                    buf = pinned[i][k] = torch.empty(
                        src.shape, dtype=src.dtype, pin_memory=True)
                    allocs += 1
                    nbytes += buf.numel() * buf.element_size()
                buf.copy_(src)
                out[k] = _copy_to(buf, device)
            events[i] = torch.cuda.Event()
            events[i].record(side)
        _count(stage_ns=time.perf_counter_ns() - t0, pin_allocs=allocs,
               pinned_bytes=nbytes)
        return out, events[i]

    for out, event in _produce(iterator, stage, depth):
        _count(batches=1)
        yield _hand_over(out, keys, event, device)


device_feed.feeds = device_feed.batches = device_feed.next_ns = 0
device_feed.stage_ns = device_feed.pin_allocs = device_feed.pinned_bytes = 0
