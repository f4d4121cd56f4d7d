"""Deterministic data loading (counterpart of
``deeperspeed_tpu/runtime/dataloader.py``, numpy only).

``DeeperSpeedDataLoader`` batches a map-style dataset with a seeded,
epoch-stable shuffle (``np.random.RandomState(seed + epoch)``), so its
batches equal the JAX package's loader's for the same dataset and seed on
one process; with ``num_shards`` processes each takes its contiguous slice
of every global batch (``shard_index``), as the JAX loader does.
``RepeatingLoader`` wraps any loader into an infinite iterator (reference
``dataloader.py:17``).  ``DevicePrefetchingLoader`` runs the engine's
loader ``comm.overlap.prefetch_depth`` steps ahead, each step's batches
copied to the card on a side stream while the step before runs.
"""

import collections

import numpy as np
import torch


class DevicePrefetchingLoader:
    """Copies the batches of the next ``depth`` steps to ``device`` ahead
    of their use (JAX ``DevicePrefetchingLoader``: there the asynchronous
    ``device_put`` of the steps ahead overlaps the current step).

    Each delivered item is one step: ``pulls_per_batch`` items of
    ``iterator`` (the engine's microbatches, each a dict of arrays), as a
    list of dicts of tensors on ``device``.  On a CUDA device the host
    arrays are pinned and copied ``non_blocking`` on a side stream; an
    event recorded there orders each step's copies before the compute
    stream uses them, and ``record_stream`` keeps the caching allocator
    from reusing their memory while the compute stream may still read it.
    On the CPU the arrays become tensors in place, with no stream.

    Checkpointing: ``position()`` is the source loader's state
    (``position_fn``) from before the oldest step still buffered was
    pulled, so a resume re-delivers the batches a save threw away (None
    without ``position_fn``)."""

    def __init__(self, iterator, device, depth=1, position_fn=None, pulls_per_batch=1):
        self.iterator = iterator
        self.device = torch.device(device)
        self.depth = max(1, int(depth))
        self.position_fn = position_fn
        self.pulls_per_batch = max(1, int(pulls_per_batch))
        self.stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                       else None)
        self._buf = collections.deque()
        self._exhausted = False

    def _put(self, micro):
        if self.stream is None:
            return [{k: torch.as_tensor(v).to(self.device) for k, v in mb.items()}
                    for mb in micro], None
        pinned = [{k: torch.as_tensor(v).pin_memory() for k, v in mb.items()}
                  for mb in micro]
        with torch.cuda.stream(self.stream):
            out = [{k: v.to(self.device, non_blocking=True) for k, v in mb.items()}
                   for mb in pinned]
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready

    def _fill(self):
        while not self._exhausted and len(self._buf) < self.depth:
            pos = self.position_fn() if self.position_fn is not None else None
            try:
                micro = [next(self.iterator) for _ in range(self.pulls_per_batch)]
            except StopIteration:
                self._exhausted = True
                return
            self._buf.append((*self._put(micro), pos))

    def __iter__(self):
        return self

    def __next__(self):
        self._fill()
        if not self._buf:
            raise StopIteration
        micro, ready, _ = self._buf.popleft()
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            for mb in micro:
                for t in mb.values():
                    t.record_stream(current)
        # refill at once: the next steps' copies overlap this step
        self._fill()
        return micro

    def position(self):
        if self._buf:
            return self._buf[0][2]
        return self.position_fn() if self.position_fn is not None else None


class RepeatingLoader:
    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


class DeeperSpeedDataLoader:
    """Batches a map-style dataset deterministically.

    ``dataset`` may be: a dict of numpy arrays (column store), a sequence of
    examples (dicts or tuples), or anything with ``__getitem__``/``__len__``.
    Shuffling is seeded and epoch-stable: the same seed and epoch give the
    same permutation on every process.  ``batch_size`` is the global batch;
    process ``shard_index`` of ``num_shards`` (by default the
    ``torch.distributed`` rank and world) gets its contiguous slice of it.
    """

    def __init__(self, dataset, batch_size, collate_fn=None, drop_last=True,
                 shuffle=True, seed=1234, sampler=None, num_shards=None,
                 shard_index=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self._batch_idx = 0        # batches delivered in the current epoch
        self._resume_batch_idx = 0  # fast-forward target after a restore
        # optional index sampler (curriculum data sampler): an object whose
        # ``next_batch_indices()`` yields the global batch's sample ids
        # (reference DeepSpeedDataSampler consumed by ``deepspeed_io``)
        self.sampler = sampler
        if num_shards is None:
            from .. import comm

            num_shards, shard_index = comm.get_world_size(), comm.get_rank()
        self.num_shards = num_shards
        self.shard_index = shard_index or 0
        if batch_size % num_shards:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{num_shards} processes")
        if isinstance(dataset, dict):
            lens = {k: len(v) for k, v in dataset.items()}
            assert len(set(lens.values())) == 1, f"ragged columns: {lens}"
            self._n = next(iter(lens.values()))
            self._columnar = True
        else:
            self._n = len(dataset)
            self._columnar = False

    def set_epoch(self, epoch):
        self.epoch = epoch

    # -- checkpointable iterator position ---------------------------------
    # the (epoch, batch_idx) pair fully determines the next sample under
    # the seeded epoch-stable shuffle, so persisting it in
    # ``engine_state.json`` makes resume consume the exact batches an
    # uninterrupted run would -- no replay, no skips

    def state_dict(self):
        return {"epoch": int(self.epoch), "batch_idx": int(self._batch_idx)}

    def load_state_dict(self, state):
        b = int(state.get("batch_idx", 0))
        n = max(len(self), 1)
        # batch_idx == len(self) means the epoch's last batch was delivered
        # but the generator never resumed to roll the epoch over -- resume
        # at the next epoch's start, not by replaying this one
        self.epoch = int(state.get("epoch", 0)) + b // n
        self._resume_batch_idx = b % n

    def __len__(self):
        if self.drop_last:
            return self._n // self.batch_size
        return (self._n + self.batch_size - 1) // self.batch_size

    def _shard(self, idx):
        """This process's contiguous slice of a global batch's indices (the
        rows the JAX batch sharding over dp gives it)."""
        if self.num_shards == 1:
            return idx
        if len(idx) % self.num_shards:
            raise ValueError(f"batch of {len(idx)} samples not divisible by "
                             f"{self.num_shards} processes; use drop_last=True or "
                             f"a divisible batch size")
        per = len(idx) // self.num_shards
        return idx[self.shard_index * per:(self.shard_index + 1) * per]

    def __iter__(self):
        start, self._resume_batch_idx = self._resume_batch_idx, 0
        if self.sampler is not None:
            for i in range(len(self)):
                batch_idx = np.asarray(self.sampler.next_batch_indices())
                if i < start:
                    continue  # fast-forward: sampler state still advances
                self._batch_idx = i + 1
                yield self._gather(self._shard(batch_idx))
            self.epoch += 1
            self._batch_idx = 0
            return
        order = np.arange(self._n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        for i in range(start, len(self)):
            idx = self._shard(order[i * self.batch_size:(i + 1) * self.batch_size])
            # set BEFORE yield: while the generator is suspended mid-epoch,
            # state_dict() must equal the count of batches already delivered
            self._batch_idx = i + 1
            yield self._gather(idx)
        self.epoch += 1
        self._batch_idx = 0

    def _gather(self, idx):
        if self._columnar:
            batch = {k: np.asarray(v)[idx] for k, v in self.dataset.items()}
        else:
            examples = [self.dataset[int(i)] for i in idx]
            if self.collate_fn is not None:
                return self.collate_fn(examples)
            first = examples[0]
            if isinstance(first, dict):
                batch = {k: np.stack([e[k] for e in examples]) for k in first}
            elif isinstance(first, (tuple, list)):
                batch = tuple(np.stack([e[j] for e in examples]) for j in range(len(first)))
            else:
                batch = np.stack(examples)
        if self.collate_fn is not None:
            return self.collate_fn(batch)
        return batch
