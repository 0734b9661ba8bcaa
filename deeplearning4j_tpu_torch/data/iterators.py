"""DataSet iterators: the base contract, in-memory batching and the
wrappers.

Counterpart of deeplearning4j_tpu/data/iterators.py (parity surface: the
reference's DataSetIterator contract, ListDataSetIterator,
ExistingDataSetIterator, AsyncDataSetIterator, MultipleEpochsIterator and
JointParallelDataSetIterator). A pre-processor (data/normalizers.py)
applies to every batch an iterator emits, unless it is ``device_side``:
then the containers apply its device transform after the copy to the card
(``resolve_pre_processor`` finds it through the wrappers' ``base``).

``AsyncDataSetIterator`` overlaps host-side work (the base's pull, its
pre-processor, an optional ``transform`` such as decoding) with the
device's steps on background threads behind a bounded queue; the copy to
the card is the containers' prefetcher's (data/prefetcher.py), after it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """Base contract: iterable of DataSet with reset(). ``iter()`` resets,
    as in the JAX package (and ``fit`` resets before each epoch too, so a
    shuffling iterator advances its seed the same way in both)."""

    pre_processor = None

    def set_pre_processor(self, pp):
        """Attach a normalizer (parity: setPreProcessor)."""
        self.pre_processor = pp
        return self

    def _emit(self, ds: DataSet) -> DataSet:
        pp = self.pre_processor
        if pp is not None and not getattr(pp, "device_side", False):
            ds = pp.pre_process(ds)
        return ds

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        raise NotImplementedError

    def reset(self):
        pass

    def batch(self) -> int:
        return -1

    def total_outcomes(self) -> int:
        return -1

    def input_columns(self) -> int:
        return -1


class ListDataSetIterator(DataSetIterator):
    """Batches an in-memory DataSet (parity: ListDataSetIterator); with
    ``shuffle`` each reset draws a new order from ``seed + epoch``."""

    def __init__(self, dataset: DataSet, batch_size: int, shuffle=False,
                 seed=123, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        self._pos = 0
        self._order = np.arange(dataset.num_examples())

    def reset(self):
        self._pos = 0
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            self._order = rng.permutation(self.dataset.num_examples())
        self._epoch += 1

    def __next__(self):
        n = self.dataset.num_examples()
        if self._pos >= n:
            raise StopIteration
        end = min(self._pos + self.batch_size, n)
        if self.drop_last and end - self._pos < self.batch_size:
            raise StopIteration
        idx = self._order[self._pos:end]
        self._pos = end
        return self._emit(self.dataset._rows(idx))

    def batch(self):
        return self.batch_size

    def total_outcomes(self):
        return int(self.dataset.labels.shape[-1])

    def input_columns(self):
        return int(np.prod(self.dataset.features.shape[1:]))


class ExistingDataSetIterator(DataSetIterator):
    """Wraps a list/iterable of DataSets (parity: ExistingDataSetIterator)."""

    def __init__(self, datasets: List[DataSet]):
        self.datasets = list(datasets)
        self._pos = 0

    def reset(self):
        self._pos = 0

    def __next__(self):
        if self._pos >= len(self.datasets):
            raise StopIteration
        d = self.datasets[self._pos]
        self._pos += 1
        return self._emit(d)


class AsyncDataSetIterator(DataSetIterator):
    """Background prefetch + parallel-ETL wrapper.

    At ``workers=1`` this is the reference's AsyncDataSetIterator (one
    prefetch thread, queue size = prefetch buffer). At ``workers=N`` it
    plays the reference's ParallelDataSetIterator role: N threads pull
    batches from the base (serialized by a lock -- the pull is the cheap
    part) and run the expensive per-batch work concurrently -- the base's
    host-side pre-processor and the optional ``transform`` callable
    (decode/augment, e.g. bytes -> DataSet) both execute inside the
    workers, so ETL overlaps device compute AND itself.

    ``ordered=True`` (default) emits batches in exact base order -- training
    through it is bitwise-identical to training through the base directly.
    ``ordered=False`` emits batches as workers finish them (lower latency
    jitter, order nondeterministic). The queue stays bounded either way:
    backpressure reaches the base when the consumer falls behind.

    Worker errors propagate to the consumer: every in-order batch decoded
    before the failure is delivered, then the error raises from
    ``__next__``. ``reset()``/``_shutdown()`` stop workers promptly even
    when they are blocked on a full queue (the drain loop runs until every
    worker has exited, not just once)."""

    _SENTINEL = object()

    def __init__(self, base: DataSetIterator, queue_size: int = 4,
                 workers: int = 1, ordered: bool = True, transform=None):
        if workers < 1:
            raise ValueError(f"workers must be at least 1, got {workers}")
        self.base = base
        self.queue_size = queue_size
        self.workers = int(workers)
        self.ordered = ordered
        self.transform = transform
        self._q = None
        self._threads = []
        self._error = None
        self._stop = None
        self._stash = {}
        self._next_seq = 0
        self._done = False

    def reset(self):
        self._shutdown()
        self.base.reset()
        self._q = queue.Queue(maxsize=self.queue_size)
        self._error = None
        self._stop = stop = threading.Event()
        self._stash = {}
        self._next_seq = 0
        self._done = False
        q = self._q
        pull_lock = threading.Lock()   # base iterators are not thread-safe
        state_lock = threading.Lock()
        shared = {"seq": 0, "live": self.workers}

        def worker():
            try:
                while not stop.is_set():
                    with pull_lock:
                        if stop.is_set():
                            break
                        try:
                            item = next(self.base)
                        except StopIteration:
                            break
                        seq = shared["seq"]
                        shared["seq"] += 1
                    # the parallel part: decode/augment outside the lock
                    if self.transform is not None:
                        item = self.transform(item)
                    while not stop.is_set():
                        try:
                            q.put((seq, item), timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except Exception as e:  # propagate ETL errors to consumer
                with state_lock:
                    if self._error is None:
                        self._error = e
            finally:
                with state_lock:
                    shared["live"] -= 1
                    last = shared["live"] == 0
                if last:
                    while not stop.is_set():
                        try:
                            q.put(self._SENTINEL, timeout=0.1)
                            break
                        except queue.Full:
                            continue

        self._threads = [threading.Thread(target=worker, daemon=True)
                         for _ in range(self.workers)]
        for t in self._threads:
            t.start()
        self._consumed = False

    def __iter__(self):
        # only restart the workers if this wrapper has already handed out
        # items: fit() calls reset() and THEN iterates, and a second reset
        # here would discard prefetched batches -- destructive for
        # forward-only bases (a streaming source)
        if self._q is None or getattr(self, "_consumed", True):
            self.reset()
        return self

    def __next__(self):
        if self._q is None:
            self.reset()
        self._consumed = True
        while True:
            if self.ordered and self._next_seq in self._stash:
                item = self._stash.pop(self._next_seq)
                self._next_seq += 1
                # honor a processor set on THIS wrapper (base applies its own)
                return self._emit(item)
            if self._done:
                # every contiguous in-order batch was already delivered by
                # the stash pop above; a remaining stash means a worker
                # error left a gap in the sequence -- raise it here
                if self._error is not None:
                    raise self._error
                if self._stash:         # defensive: gap without an error
                    seq = min(self._stash)
                    item = self._stash.pop(seq)
                    self._next_seq = seq + 1
                    return self._emit(item)
                raise StopIteration
            try:
                got = self._q.get(timeout=0.5)
            except queue.Empty:
                # workers may have died with a full queue and dropped the
                # sentinel; don't block forever
                if not any(t.is_alive() for t in self._threads):
                    self._done = True
                continue
            if got is self._SENTINEL:
                self._done = True
                continue
            seq, item = got
            if not self.ordered:
                return self._emit(item)
            self._stash[seq] = item

    def _shutdown(self):
        threads = [t for t in self._threads if t.is_alive()]
        if threads:
            self._stop.set()
            # workers blocked in q.put free a slot only when we drain; one
            # drain pass is NOT enough -- a worker can refill the slot before
            # observing the stop flag. Alternate drain/join until every
            # worker has exited (each put/get timeout is 0.1 s, so this
            # converges in a bounded number of rounds).
            deadline = time.monotonic() + 10.0
            while threads and time.monotonic() < deadline:
                try:
                    while True:
                        self._q.get_nowait()
                except queue.Empty:
                    pass
                for t in threads:
                    t.join(timeout=0.05)
                threads = [t for t in threads if t.is_alive()]
        self._threads = []
        self._q = None
        self._stop = None
        self._stash = {}


# The async prefetch wrapper is payload-agnostic (it just pulls next(base)
# on a worker thread), so the MultiDataSet variant the reference ships as a
# separate class (AsyncMultiDataSetIterator.java, used by
# ComputationGraph.fit) is the same implementation here.
AsyncMultiDataSetIterator = AsyncDataSetIterator


class MultipleEpochsIterator(DataSetIterator):
    """Replays a base iterator N times (parity: MultipleEpochsIterator)."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self.epochs = epochs
        self.base = base
        self._epoch = 0

    def reset(self):
        self._epoch = 0
        self.base.reset()

    def __next__(self):
        try:
            return self._emit(next(self.base))
        except StopIteration:
            self._epoch += 1
            if self._epoch >= self.epochs:
                raise
            self.base.reset()
            return self._emit(next(self.base))


class InequalityHandling:
    """What a JointParallelDataSetIterator consumer does when its producer
    runs dry (parity: datasets/iterator/parallel/InequalityHandling.java)."""
    PASS_NULL = "pass_null"
    STOP_EVERYONE = "stop_everyone"
    RESET = "reset"
    RELOCATE = "relocate"


class JointParallelDataSetIterator(DataSetIterator):
    """Feeds N consumers (one per device/worker) from N producer iterators
    (parity: datasets/iterator/parallel/JointParallelDataSetIterator.java --
    per-consumer ``has_next_for``/``next_for``, plus plain iteration that
    interleaves producers round-robin). Each producer is wrapped in an
    AsyncDataSetIterator for background prefetch, matching the reference's
    initializeIterators; dry producers follow the InequalityHandling policy."""

    _EMPTY = object()

    def __init__(self, iterators,
                 inequality_handling=InequalityHandling.STOP_EVERYONE,
                 buffer_size: int = 4, async_prefetch: bool = True):
        if not iterators:
            raise ValueError(
                "You can't start ParallelDataSetIterator without input data")
        self.producers = [AsyncDataSetIterator(it, queue_size=buffer_size)
                          if async_prefetch else it for it in iterators]
        self.inequality = inequality_handling
        self._heads = [self._EMPTY] * len(self.producers)  # lookahead slots
        self._stopped = False
        self._cursor = 0

    @property
    def num_producers(self):
        return len(self.producers)

    def _check(self, consumer):
        if consumer < 0 or consumer >= len(self.producers):
            raise IndexError(f"Non-existent consumer {consumer} requested")

    def _pull(self, consumer) -> bool:
        """Fill the lookahead slot from the producer. True if data present."""
        if self._heads[consumer] is not self._EMPTY:
            return True
        try:
            self._heads[consumer] = next(self.producers[consumer])
            return True
        except StopIteration:
            return False

    def has_next_for(self, consumer: int) -> bool:
        self._check(consumer)
        if self._stopped:
            return False
        if self._pull(consumer):
            return True
        # producer dry -- apply the inequality policy
        if self.inequality == InequalityHandling.STOP_EVERYONE:
            self._stopped = True
            return False
        if self.inequality == InequalityHandling.RESET:
            self.producers[consumer].reset()
            return self._pull(consumer)
        if self.inequality == InequalityHandling.RELOCATE:
            return any(self._pull(c) for c in range(len(self.producers)))
        return False                                   # PASS_NULL

    def next_for(self, consumer: int):
        """The consumer's next DataSet, or None when its producer is dry
        under PASS_NULL/STOP_EVERYONE (the reference returns null)."""
        if not self.has_next_for(consumer):
            return None
        if self._heads[consumer] is not self._EMPTY:
            item = self._heads[consumer]
            self._heads[consumer] = self._EMPTY
            return item
        if self.inequality == InequalityHandling.RELOCATE:
            for c in range(len(self.producers)):
                if self._heads[c] is not self._EMPTY:
                    item = self._heads[c]
                    self._heads[c] = self._EMPTY
                    return item
        return None

    # round-robin single-consumer view (DataSetIterator protocol)
    def __next__(self):
        n = len(self.producers)
        for off in range(n):
            c = (self._cursor + off) % n
            if self.has_next_for(c):
                self._cursor = (c + 1) % n
                item = self.next_for(c)
                if item is not None:
                    return item
            if self._stopped:
                break
        raise StopIteration

    def reset(self):
        for p in self.producers:
            p.reset()
        self._heads = [self._EMPTY] * len(self.producers)
        self._stopped = False
        self._cursor = 0


def resolve_pre_processor(data):
    """The pre-processor attached to ``data`` or to an iterator it wraps
    (its ``base``, up to 8 hops), or None."""
    d, hops = data, 0
    while d is not None and hops < 8:
        pp = getattr(d, "pre_processor", None)
        if pp is not None:
            return pp
        d = getattr(d, "base", None)
        hops += 1
    return None
