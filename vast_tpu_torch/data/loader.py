"""Batch loading and multi-dataset mixing.

The port's own copy of ``vast_tpu.data.loader`` (loader.py:28-233).
``BatchLoader`` shards a (shuffled) index order by host, fetches samples
on a thread pool and collates batches on a producer thread, a few
batches ahead; an exception in the producer reaches the consumer.
``MetaLoader`` is the reference's data/loader.py:8-60: each dataset name
enters a sampling pool ``steps`` times, each step draws a name from the
pool with a seeded RNG, and the draw holds for a gradient-accumulation
window; ``skip`` moves past a resumed run's steps without reading them
(a stream's: by reading and dropping them, ``StreamBatchLoader``).
``StreamBatchLoader`` batches an iterable ``srcindexed`` stream on a
producer thread. ``compute_train_steps`` derives the step counts
(utils/build_dataloader.py:40-77).
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor

from vast_tpu_torch.logger import LOGGER


class BatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 drop_last: bool = True, num_workers: int = 4, seed: int = 50,
                 host_id: int = 0, num_hosts: int = 1, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = prefetch
        self.epoch = 0
        self.padded_tail = 0  # set per epoch by _indices()

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return (len(self.dataset) // self.num_hosts) // self.batch_size
        per_host = -(-len(self.dataset) // self.num_hosts)  # ceil
        return -(-per_host // self.batch_size)

    def _indices(self):
        """Host-strided index shard, padded so that every host yields the
        same number of equally shaped batches: a shard shorter than
        ceil(n / num_hosts) repeats its last index, and ``padded_tail``
        records how many trailing rows of this host's epoch are such
        duplicates, so that evaluation drops them before it gathers.
        """
        n = len(self.dataset)
        order = list(range(n))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        # contiguous host shard (DistributedSampler-style interleave)
        mine = order[self.host_id::self.num_hosts]
        self.padded_tail = 0
        if self.num_hosts > 1 and not self.drop_last and n:
            target = -(-n // self.num_hosts)
            fill = mine[-1] if mine else order[0]
            self.padded_tail = target - len(mine)
            mine = mine + [fill] * self.padded_tail
        return mine

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start: int):
        """This epoch's batches from batch ``start`` on; the samples of
        the batches before it are never read."""
        idxs = self._indices()
        nb = len(self)
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # exceptions travel through the queue: a dead producer would
            # otherwise leave the consumer blocked in out_q.get() forever
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for bi in range(start, nb):
                        if stop.is_set():
                            return
                        chunk = idxs[bi * self.batch_size:
                                     (bi + 1) * self.batch_size]
                        samples = list(pool.map(self.dataset.__getitem__,
                                                chunk))
                        out_q.put(self.dataset.collate(samples))
                out_q.put(None)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                out_q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                b = out_q.get()
                if b is None:
                    return
                if isinstance(b, BaseException):
                    raise b
                yield b
        finally:
            stop.set()


# the length a dataset without __len__ (a stream) stands for in the step
# counts (vast_tpu pipeline.py:129); a stream's data_cfg gives its steps
STREAM_LENGTH = 10 ** 9


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put ``item`` on the bounded ``q`` unless ``stop`` is set first:
    a producer whose consumer has left must not block forever."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            pass
    return False


class StreamBatchLoader:
    """Batches of an iterable dataset (the ``srcindexed`` tar streams,
    vast_tpu loader.py:120-168), collated with the dataset's collate on a
    producer thread a few batches ahead. The dataset shards itself by
    host. A training stream never ends; an evaluation one ends with a
    last, shorter batch. An exception in the producer reaches the
    consumer; the producer stops when the consumer leaves.

    Resume (:meth:`iter_from`): a stream cannot seek, so the batches
    before ``start`` are read and dropped. They pass through the same
    shard shuffle, shuffle buffer and caption draws, from the same seed,
    so the batches after them are those an unbroken run reads."""

    def __init__(self, dataset, batch_size: int, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = prefetch

    def set_epoch(self, epoch: int):
        pass

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start: int):
        """The stream's batches from batch ``start`` on; the samples of
        the batches before it are read and dropped."""
        drop = start * self.batch_size
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                buf = []
                for i, sample in enumerate(self.dataset):
                    if stop.is_set():
                        return
                    if i < drop:
                        continue
                    buf.append(sample)
                    if len(buf) == self.batch_size:
                        if not _put(out_q, self.dataset.collate(buf), stop):
                            return
                        buf = []
                if buf and not _put(out_q, self.dataset.collate(buf), stop):
                    return
                _put(out_q, None, stop)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                _put(out_q, e, stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                b = out_q.get()
                if b is None:
                    return
                if isinstance(b, BaseException):
                    raise b
                yield b
        finally:
            stop.set()


class MetaLoader:
    """Weighted multi-task mixing (data/loader.py:8-60).

    loaders: dict name -> (BatchLoader, ratio). Iteration is infinite;
    termination is the trainer's step budget (utils/pipeline.py:141).
    """

    def __init__(self, loaders: dict, accum_steps: int = 1, seed: int = 50):
        self.name2loader = {}
        self.name2iter = {}
        self.sampling_pools = []
        self.name2epoch = {}
        for name, (loader, ratio) in loaders.items():
            self.name2loader[name] = loader
            self.name2iter[name] = iter(loader)
            self.name2epoch[name] = 0
            # floor at 1 pool slot: a dataset whose derived step count
            # rounds to 0 (tiny set, large global batch) must still be
            # sampled, not silently excluded — and an all-zero pool
            # would crash rng.choice([])
            if int(ratio) < 1:
                LOGGER.warning("MetaLoader: dataset %r ratio %s < 1; "
                               "flooring to 1 sampling slot", name, ratio)
            self.sampling_pools.extend([name] * max(1, int(ratio)))
        self.accum_steps = accum_steps
        self.step = 0
        self._rng = random.Random(seed)
        self._held_task = None
        self.ndata = len(loaders)

    def skip(self, n: int):
        """Advance a fresh MetaLoader past ``n`` steps without reading a
        sample: the same task draws as ``n`` steps of iteration, and each
        loader resumes at the epoch and batch its next step would read
        (a stream reads and drops the batches it skips)."""
        if self.step:
            raise ValueError("skip() needs a MetaLoader not yet iterated")
        taken = dict.fromkeys(self.name2loader, 0)
        for _ in range(n):
            if self.step % self.accum_steps == 0:
                self._held_task = self._rng.choice(self.sampling_pools)
            self.step += 1
            taken[self._held_task] += 1
        for name, k in taken.items():
            if not k:
                continue
            loader = self.name2loader[name]
            if not hasattr(loader, "__len__"):
                # a stream: one endless epoch, its k batches read and
                # dropped (StreamBatchLoader.iter_from)
                self.name2iter[name] = loader.iter_from(k)
                continue
            if not len(loader):
                raise ValueError(f"dataset {name!r} yields no batch")
            # k batches read: the next is batch k % len of epoch k // len
            epoch, start = divmod(k, len(loader))
            self.name2epoch[name] = epoch
            loader.set_epoch(epoch)
            self.name2iter[name] = loader.iter_from(start)

    def __iter__(self):
        while True:
            if self.step % self.accum_steps == 0:
                self._held_task = self._rng.choice(self.sampling_pools)
            name = self._held_task
            self.step += 1
            try:
                batch = next(self.name2iter[name])
            except StopIteration:
                self.name2epoch[name] += 1
                loader = self.name2loader[name]
                if hasattr(loader, "set_epoch"):
                    loader.set_epoch(self.name2epoch[name])
                self.name2iter[name] = iter(loader)
                batch = next(self.name2iter[name])
            yield name, batch


def compute_train_steps(data_cfg_train, run_cfg, dataset_lengths):
    """train_steps per dataset + derived num_train_steps / valid_steps
    (utils/build_dataloader.py:40-77)."""
    train_steps = []
    for d_cfg, n in zip(data_cfg_train, dataset_lengths):
        if "steps" in d_cfg:
            train_steps.append(int(d_cfg["steps"]))
        else:
            epoch = d_cfg.get("epoch", 1)
            train_steps.append(int((n // d_cfg["batch_size"]) * epoch))
    if not run_cfg.get("num_train_steps"):
        run_cfg.num_train_steps = sum(train_steps)
    run_cfg.valid_steps = max(
        run_cfg.num_train_steps // run_cfg.get("valid_freq", 10) - 1, 1)
    return train_steps
