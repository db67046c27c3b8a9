"""Threaded prefetching data loader (the port's copy of
``opendwm_tpu/datasets/loader.py``).

Capability parity with the reference's torch DataLoader configs
(``training_dataloader: {batch_size, num_workers, prefetch_factor,
collate_fn, persistent_workers}`` — e.g. reference
configs/ctsd/multi_datasets/*.json). torch's loader forks worker
processes; here a thread pool fetches dataset items concurrently — the
hot work (PIL decode, zlib inflate, numpy, the C++ data plane in
opendwm_tpu_torch/native) releases the GIL, so threads overlap IO/decode with
the device step without fork/CoW hazards — and a producer thread
keeps a bounded queue of collated batches ahead of the training loop.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

_SENTINEL = object()


def index_batches(n: int, batch_size: int, sampler=None, seed: int = 0,
                  skip: int = 0):
    """The dataset indices of each batch, without end: the sampler's
    micro-batches epoch after epoch (``set_epoch`` between them), else
    each epoch a permutation of ``n`` drawn from ``seed``, cut into whole
    batches. The first ``skip`` batches are passed over (a resumed run
    takes the batches an uninterrupted one takes)."""
    def stream():
        if sampler is not None:
            while True:
                for micro in sampler:
                    yield list(micro)
                sampler.set_epoch(getattr(sampler, "epoch", 0) + 1)
        if n < batch_size:
            raise ValueError(f"dataset of {n} items is smaller than one "
                             f"batch of {batch_size}")
        rng = np.random.default_rng(seed)
        while True:
            order = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                yield [int(j) for j in order[i: i + batch_size]]

    for indices in stream():
        if skip:
            skip -= 1
            continue
        yield indices


class PrefetchLoader:
    """Iterate collated batches with background item fetch + batch queue.

    The batches of ``train.batch_iterator`` (``index_batches``: sampler
    epochs or seeded shuffle, the first ``skip`` passed over) with
    ``prefetch_batches`` kept ready. The iterator is infinite, like the
    step-based training loop expects.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        sampler=None,
        seed: int = 0,
        num_workers: int = 4,
        prefetch_batches: int = 2,
        to_device: Optional[Callable] = None,
        skip: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.sampler = sampler
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.to_device = to_device
        self.skip = skip
        self._queue: queue.Queue = queue.Queue(self.prefetch_batches)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _produce(self, stop: threading.Event, out_queue: queue.Queue):
        # stop/out_queue are passed in (not read off self) so a producer
        # orphaned by re-iteration can never feed the replacement queue.
        def put_with_stop_check(item):
            # Bounded put that gives up when the consumer abandoned
            # iteration (a blocking put on a full queue would hang the
            # thread forever).
            while not stop.is_set():
                try:
                    out_queue.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        with ThreadPoolExecutor(self.num_workers) as pool:
            try:
                for indices in index_batches(
                        len(self.dataset), self.batch_size, self.sampler,
                        self.seed, self.skip):
                    if stop.is_set():
                        break
                    items = list(
                        pool.map(self.dataset.__getitem__, indices)
                    )
                    batch = self.collate_fn(items)
                    if self.to_device is not None:
                        batch = self.to_device(batch)
                    put_with_stop_check(batch)
            except Exception as e:  # surface worker errors to the consumer
                put_with_stop_check(e)
            finally:
                put_with_stop_check(_SENTINEL)

    def __iter__(self):
        if self._thread is not None and self._thread.is_alive():
            # Two producers feeding one queue would interleave batches;
            # stop the previous iteration's producer first.
            self.close()
        if self._stop.is_set():
            # Fresh stop/queue after close() (explicit or via the branch
            # above) — a producer started with a set stop flag would exit
            # without ever enqueuing the sentinel, hanging the consumer.
            self._stop = threading.Event()
            self._queue = queue.Queue(self.prefetch_batches)
        self._thread = threading.Thread(
            target=self._produce, args=(self._stop, self._queue), daemon=True
        )
        self._thread.start()
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        self._stop.set()
        # drain so the producer can observe the stop flag
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
