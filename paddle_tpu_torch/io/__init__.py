"""paddle.io of the port: Dataset, samplers and the prefetching
DataLoader.

Port of ``paddle_tpu/io/__init__.py``. Batches are collated as numpy on
the host by a background thread and land on the device when a step
wraps them (``Model.fit``, ``to_tensor``); the consumer's wait is the
goodput ledger's ``input_wait`` and a ``dataloader/wait`` span, as in
the reference. ``io/fs.py`` (the HDFS/local file-system helpers) is not
ported.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, List, Sequence

import numpy as np

from .. import goodput as _goodput
from .. import monitor as _monitor
from .. import profiler as _profiler

# feeding-pipeline telemetry: a drained queue (depth 0, rising wait
# times) means the host can't keep the device fed — the classic input
# bottleneck the run report surfaces
_M_QDEPTH = _monitor.gauge(
    "dataloader_queue_depth", "prefetch queue occupancy after each take")
_M_WAIT = _monitor.histogram(
    "dataloader_wait_seconds", "consumer blocking time per batch take")
_M_BATCHES = _monitor.counter(
    "dataloader_batches_total", "batches yielded to the training loop")


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise TypeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        self.tensors = [np.asarray(t) for t in tensors]
        assert all(len(t) == len(self.tensors[0]) for t in self.tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    assert sum(lengths) == len(dataset)
    perm = np.random.permutation(len(dataset))
    out = []
    off = 0
    for n in lengths:
        out.append(Subset(dataset, perm[off : off + n].tolist()))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards sample indices across data-parallel ranks (reference
    python/paddle/fluid/dataloader/batch_sampler.py DistributedBatchSampler)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None, shuffle=False, drop_last=False):
        import os

        from ..monitor import trainer_rank

        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = (num_replicas if num_replicas is not None
                       else int(os.environ.get("PADDLE_TRAINERS_NUM", 1)))
        self.rank = rank if rank is not None else trainer_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
            self.epoch += 1
        else:
            indices = list(range(n))
        indices += indices[: (self.total_size - len(indices))]
        indices = indices[self.rank : self.total_size : self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch: List[Any]):
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch]) for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    arr = np.stack([np.asarray(s) for s in batch])
    return arr


class DataLoader:
    """Queue-prefetching loader (reference reader.py DataLoader): a
    background thread collates the next batches while the consumer runs
    (numpy releases the GIL)."""

    def __init__(
        self,
        dataset,
        feed_list=None,
        places=None,
        return_list=True,
        batch_sampler=None,
        batch_size=1,
        shuffle=False,
        drop_last=False,
        collate_fn=None,
        num_workers=0,
        use_buffer_reader=True,
        prefetch_factor=2,
        timeout=0,
        worker_init_fn=None,
    ):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.prefetch = max(2, prefetch_factor)
        self.use_buffer = use_buffer_reader and num_workers >= 0
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size, drop_last=drop_last
            )

    def __len__(self):
        return len(self.batch_sampler)

    def _produce(self):
        for batch_idx in self.batch_sampler:
            samples = [self.dataset[i] for i in batch_idx]
            yield self.collate_fn(samples)

    def __iter__(self):
        if not self.use_buffer:
            it = self._produce()
            while True:
                t0 = time.perf_counter()
                # span covers the synchronous dataset work per batch
                with _profiler.span("dataloader/next", cat="dataloader"):
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                # unbuffered: the whole produce time blocks the consumer
                _goodput.add("input_wait", time.perf_counter() - t0)
                _M_BATCHES.inc()
                yield item
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END = object()

        def worker():
            try:
                for item in self._produce():
                    q.put(item)
            finally:
                q.put(_END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            t0 = time.perf_counter()
            # span covers consumer blocking time: a wide dataloader/wait
            # band in the timeline IS the input bottleneck
            with _profiler.span("dataloader/wait", cat="dataloader"):
                item = q.get()
            if item is _END:  # shutdown sentinel is not a batch take
                break
            wait = time.perf_counter() - t0
            _M_WAIT.observe(wait)
            # goodput: consumer blocking time IS the input-starvation
            # bucket (a well-fed queue makes this ~0 even while the
            # producer thread still works)
            _goodput.add("input_wait", wait)
            _M_QDEPTH.set(q.qsize())
            _M_BATCHES.inc()
            yield item

