"""Threaded prefetching batch loader on the host (``genvc_tpu/data/loader.py``).

Replaces the reference's torch DataLoader worker processes (dataset.py:12,
trainers/*.get_data_loader): wav decode + crop + collate run in a thread pool
(numpy releases the GIL for IO and resampling), with a bounded prefetch queue,
so the card does not wait on IO.
"""

from __future__ import annotations

import logging
import queue
import random
import threading

logger = logging.getLogger(__name__)


class BatchLoader:
    """num_shards/shard_index give data parallelism over processes: each
    reads a disjoint stride of the (epoch-shuffled, shared-seed) sample
    order, as torch's DistributedSampler (reference gpt_trainer.py:344-347).
    The defaults are one process."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4,
                 prefetch: int = 4, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0):
        assert 0 <= shard_index < num_shards
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0
        self.num_shards = num_shards
        self.shard_index = shard_index
        # reference-faithful data fault tolerance (dataset.py:122-129):
        # substitute a known-good sample for failing items instead of
        # shrinking the epoch; counters are observability for systematic
        # data failures (no silent batch drops)
        self.fallback_index = 1 if len(dataset) > 1 else 0
        self.substitutions = 0
        self.dropped_batches = 0
        self._stats_lock = threading.Lock()

    def _collate_substituting(self, idx, wrng):
        """Collate a batch; on failure, probe each item and replace the
        failing ones with the known-good ``fallback_index`` sample (the
        reference's ``__getitem__`` recursion into item 1), keeping the
        batch count intact."""
        try:
            return self.dataset.collate(idx, wrng)
        except Exception:
            pass
        good = []
        n_sub = 0
        for j in idx:
            try:
                self.dataset.collate([j], wrng)
                good.append(j)
            except Exception:
                good.append(self.fallback_index)
                n_sub += 1
        if n_sub == 0:
            # batch-level (not item-level) failure: retry once as-is so a
            # transient error doesn't drop the batch
            return self.dataset.collate(idx, wrng)
        with self._stats_lock:
            self.substitutions += n_sub
        logger.warning("substituted %d failing sample(s) in batch with item "
                       "%d (total substitutions: %d)", n_sub,
                       self.fallback_index, self.substitutions)
        return self.dataset.collate(good, wrng)

    def _shard_len(self):
        n = len(self.dataset)
        base = n // self.num_shards
        if not self.drop_last and self.shard_index < n % self.num_shards:
            base += 1
        return base

    def __len__(self):
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        rng = random.Random(self.seed + self.epoch)
        order = list(range(len(self.dataset)))
        if self.shuffle:
            rng.shuffle(order)
        if self.num_shards > 1:
            # same shuffle on every host (shared seed), disjoint strides
            order = order[self.shard_index :: self.num_shards]
            if self.drop_last:
                order = order[: len(self.dataset) // self.num_shards]
        batches = []
        for i in range(0, len(order), self.batch_size):
            idx = order[i : i + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                continue
            batches.append(idx)
        self.epoch += 1

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        lock = threading.Lock()
        cursor = {"i": 0}

        def worker(wid):
            wrng = random.Random((self.seed, self.epoch, wid).__hash__())
            while not stop.is_set():
                with lock:
                    i = cursor["i"]
                    if i >= len(batches):
                        break
                    cursor["i"] = i + 1
                try:
                    batch = self._collate_substituting(batches[i], wrng)
                except Exception as e:  # even the substituted batch failed
                    batch = e
                q.put((i, batch))
            q.put((None, None))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        finished = 0
        produced = 0
        try:
            while finished < self.num_workers and produced < len(batches):
                i, batch = q.get()
                if i is None:
                    finished += 1
                    continue
                if isinstance(batch, Exception):
                    # substitution already failed too — drop, but loudly
                    with self._stats_lock:
                        self.dropped_batches += 1
                    logger.warning("dropping unrecoverable batch (%s); "
                                   "total dropped: %d", batch,
                                   self.dropped_batches)
                    continue
                produced += 1
                yield batch
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=0.1)
