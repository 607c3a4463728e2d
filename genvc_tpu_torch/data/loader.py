"""Threaded prefetching batch loader on the host (``genvc_tpu/data/loader.py``).

Replaces the reference's torch DataLoader worker processes (dataset.py:12,
trainers/*.get_data_loader): wav decode + crop + collate run in a thread pool
(numpy releases the GIL for IO and resampling), with a bounded prefetch queue,
so the card does not wait on IO.

Recorded (``tracing``): the span ``genvc.loader.wait`` from asking for a batch
until it is in hand, with the batch's index in its epoch.
"""

from __future__ import annotations

import logging
import queue
import random
import threading

from genvc_tpu_torch import tracing

logger = logging.getLogger(__name__)


class BatchLoader:
    """num_shards/shard_index give data parallelism over processes: each
    reads a disjoint stride of the (epoch-shuffled, shared-seed) sample
    order, as torch's DistributedSampler (reference gpt_trainer.py:344-347).
    The defaults are one process. A batch's random crops depend only on the
    seed, the epoch and the batch's index, and batches come in index order
    (the JAX loader seeds the crops by worker thread and yields batches as
    they finish, so both depend on scheduling). At most ``prefetch``
    batches are collated ahead of the one the consumer waits for.

    ``lockstep`` (implied by ``num_shards`` > 1): this loader feeds one of
    several ranks that step together, so a batch that cannot be recovered
    raises instead of being dropped; a rank that skipped it would pair its
    collectives with the others' next step."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4,
                 prefetch: int = 4, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0, lockstep: bool = False):
        assert 0 <= shard_index < num_shards
        self.lockstep = lockstep or num_shards > 1
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
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

        # claims run at most ``prefetch`` batches ahead of the one wanted,
        # so the finished-but-early batches held below stay bounded
        q: queue.Queue = queue.Queue()
        stop = threading.Event()
        cond = threading.Condition()
        cursor = {"next": 0, "want": 0}

        def worker(wid):
            while True:
                with cond:
                    while (not stop.is_set() and cursor["next"] < len(batches)
                           and cursor["next"] >= cursor["want"] + self.prefetch):
                        cond.wait()
                    i = cursor["next"]
                    if stop.is_set() or i >= len(batches):
                        break
                    cursor["next"] = i + 1
                # the crops' random draws are seeded by the batch, not by the
                # thread that happens to collate it: the ranks of one model
                # group collate bit-identical batches at any worker count
                wrng = random.Random(hash((self.seed, self.epoch, i)))
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
        # batches are yielded in index order, whichever thread finishes
        # first: the ranks of one model group step on the same batch
        finished = 0
        pending = {}
        try:
            for want in range(len(batches)):
                with tracing.span("genvc.loader.wait", want):
                    while want not in pending and finished < self.num_workers:
                        i, batch = q.get()
                        if i is None:
                            finished += 1
                        else:
                            pending[i] = batch
                if want not in pending:
                    break
                batch = pending.pop(want)
                with cond:
                    cursor["want"] = want + 1
                    cond.notify_all()
                if isinstance(batch, Exception):
                    if self.lockstep:
                        raise RuntimeError(
                            f"batch {want} of the epoch cannot be collated, even with "
                            "substituted samples; the ranks step together, so it is "
                            "not dropped") from batch
                    # substitution already failed too — drop, but loudly
                    with self._stats_lock:
                        self.dropped_batches += 1
                    logger.warning("dropping unrecoverable batch (%s); "
                                   "total dropped: %d", batch,
                                   self.dropped_batches)
                    continue
                yield batch
        finally:
            stop.set()
            with cond:
                cond.notify_all()
            for t in threads:
                t.join(timeout=0.1)
