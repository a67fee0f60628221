"""Prefetching batch loader (counterpart of ``mintime_tpu/data/loader.py:34-230``).

Batches come in order, from ``_batches``' list (shuffled with
``np.random.default_rng((seed, epoch))`` when ``shuffle``). The workers do
each batch's file work (:meth:`DeepfakesDataset.load`: index, plan, crop
reads, size buckets) and :func:`collate` it; the main process then runs
the evaluation transform on the dataset's device
(:meth:`DeepfakesDataset.transform_crops`), so a batch's ``frames`` is a
``(B, F, S, S, 3)`` uint8 tensor there and the rest numpy.

Two worker modes:

* ``"process"`` (default on a host with more than one core): worker
  processes *spawned*, never forked, since CUDA may be live in the parent.
  The dataset's index is built in the parent first
  (:meth:`DeepfakesDataset.preload_index`) and travels pickled with the
  dataset. A spawned worker starts a fresh interpreter, so the workers are
  kept from one pass to the next and stop at :meth:`DataLoader.close` (or
  the end of a ``with`` block); a pass that ends early stops them.
* ``"thread"``: a thread pool in the main process.

A dataset error reaches the consumer as a ``RuntimeError``; a worker that
dies raises one too instead of leaving the consumer waiting. One device, so
no sharding and no padding of a last partial batch.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from mintime_torch.data.dataset import collate

#: batches queued ahead of the consumer (in process mode, beyond one a worker)
PREFETCH = 2
#: seconds between checks that the worker processes are alive
POLL_S = 1.0
#: seconds the workers get to stop before they are terminated
CLOSE_S = 5.0


def _worker_loop(dataset, task_q, out_q):
    while True:
        item = task_q.get()
        if item is None:
            return
        seq, batch_idx = item
        try:
            out_q.put((seq, collate([dataset.load(i) for i in batch_idx]), None))
        except Exception as e:  # the consumer raises it
            out_q.put((seq, None, f"{type(e).__name__}: {e}"))


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        worker_mode: str | None = None,  # "process" | "thread" | None = by core count
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        if worker_mode is None:
            worker_mode = "process" if (os.cpu_count() or 1) > 1 else "thread"
        if worker_mode not in ("process", "thread"):
            raise ValueError(f"unknown worker_mode {worker_mode!r}; 'process' or 'thread'")
        self.worker_mode = worker_mode
        self._epoch = 0
        self._workers: list = []
        self._task_q = self._out_q = None

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _batches(self) -> list[list[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(idx)
        return [idx[i : i + self.batch_size].tolist() for i in range(0, len(idx), self.batch_size)]

    def _finish(self, batch: dict) -> dict:
        """The evaluation transform of the batch's crops, on the dataset's device."""
        batch["frames"] = self.dataset.transform_crops(batch.pop("crops"))
        return batch

    def __iter__(self) -> Iterator[dict]:
        batches = self._batches()
        self._epoch += 1
        raw = self._iter_process(batches) if self.worker_mode == "process" else \
            self._iter_thread(batches)
        try:
            for batch in raw:
                yield self._finish(batch)
        finally:
            raw.close()

    # ---- process mode -----------------------------------------------------

    def _start(self, n: int) -> None:
        if self._workers:
            return
        preload = getattr(self.dataset, "preload_index", None)
        if preload is not None:
            preload(workers=max(self.num_workers, 4))
        ctx = mp.get_context("spawn")
        self._task_q, self._out_q = ctx.SimpleQueue(), ctx.Queue()
        self._workers = [ctx.Process(target=_worker_loop,
                                     args=(self.dataset, self._task_q, self._out_q), daemon=True)
                         for _ in range(n)]
        for w in self._workers:
            w.start()

    def close(self) -> None:
        """Stop the worker processes (a no-op when none runs)."""
        workers, self._workers = self._workers, []
        if not workers:
            return
        for _ in workers:
            self._task_q.put(None)
        # drain what the workers still send, so none blocks on a full pipe at exit
        deadline = time.monotonic() + CLOSE_S
        while any(w.is_alive() for w in workers) and time.monotonic() < deadline:
            try:
                self._out_q.get(timeout=0.05)
            except queue.Empty:
                pass
        for w in workers:
            if w.is_alive():
                w.terminate()
            w.join(timeout=CLOSE_S)
        self._out_q.close()
        self._task_q = self._out_q = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _iter_process(self, batches: list[list[int]]) -> Iterator[dict]:
        if not batches:
            return
        self._start(min(self.num_workers, len(batches)))
        task_q, out_q = self._task_q, self._out_q
        done = False
        try:
            # at most len(workers) + PREFETCH batches in flight, yielded in order
            pending: dict[int, dict] = {}
            submitted = next_seq = 0
            while submitted < min(len(self._workers) + PREFETCH, len(batches)):
                task_q.put((submitted, batches[submitted]))
                submitted += 1
            while next_seq < len(batches):
                while next_seq not in pending:
                    try:
                        seq, item, err = out_q.get(timeout=POLL_S)
                    except queue.Empty:
                        dead = [w.pid for w in self._workers if not w.is_alive()]
                        if dead:
                            raise RuntimeError(f"loader worker(s) died: pids {dead}") from None
                        continue
                    if err is not None:
                        raise RuntimeError(f"loader worker failed: {err}")
                    pending[seq] = item
                item = pending.pop(next_seq)
                next_seq += 1
                if submitted < len(batches):
                    task_q.put((submitted, batches[submitted]))
                    submitted += 1
                yield item
            done = True
        finally:
            if not done:  # tasks of this pass may still be in flight: start afresh next time
                self.close()

    # ---- thread mode ------------------------------------------------------

    def _iter_thread(self, batches: list[list[int]]) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        q.put((collate(list(pool.map(self.dataset.load, batch_idx))), None))
                q.put((None, None))
            except Exception as e:  # the consumer raises it
                q.put((None, f"{type(e).__name__}: {e}"))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item, err = q.get()
                if err is not None:
                    raise RuntimeError(f"loader worker failed: {err}")
                if item is None:
                    return
                yield item
        finally:
            stop.set()
            try:  # unblock a producer parked on a full queue
                q.get_nowait()
            except queue.Empty:
                pass
