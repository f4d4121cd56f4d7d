"""Curriculum-aware deterministic data sampler (a copy of
``deeperspeed_tpu/runtime/data_pipeline/data_sampling/data_sampler.py``,
numpy only).

Equivalent of reference
``runtime/data_pipeline/data_sampling/data_sampler.py``
(``DeepSpeedDataSampler``, 338 LoC): each global step draws the batch from
the "easiest" prefix of the metric-sorted sample order, where the prefix
fraction follows the curriculum difficulty ramp; within the prefix the draw
is a seeded shuffle so every dp rank sees the same global order and takes
its own contiguous slice.
"""

import numpy as np


class DeeperSpeedDataSampler:
    def __init__(self, n_samples, batch_size, curriculum_scheduler=None,
                 sorted_index=None, seed=0, drop_last=True,
                 data_parallel_rank=0, data_parallel_size=1,
                 draws_per_step=1):
        self.n_samples = n_samples
        self.batch_size = batch_size            # GLOBAL batch per draw
        # draws per *optimizer* step (= gradient_accumulation_steps when the
        # loader yields microbatches): the curriculum clock ticks once per
        # optimizer step, not per draw, so the ramp matches the configured
        # total_curriculum_step and every microbatch of one step samples
        # from the same difficulty pool.
        self.draws_per_step = max(1, draws_per_step)
        self.scheduler = curriculum_scheduler
        self.sorted_index = (np.asarray(sorted_index)
                             if sorted_index is not None else np.arange(n_samples))
        assert len(self.sorted_index) == n_samples
        self.seed = seed
        self.drop_last = drop_last
        self.dp_rank = data_parallel_rank
        self.dp_size = data_parallel_size
        assert batch_size % data_parallel_size == 0
        self.global_step = 0
        self._epoch_perm = None
        self._epoch = -1
        self._cursor = 0

    def _difficulty_fraction(self):
        if self.scheduler is None:
            return 1.0
        # +1: the first optimizer step is step 1 on the engine's clock
        # (engine._apply_data_efficiency uses global_steps + 1) -- both
        # consumers of the shared scheduler must agree
        d = self.scheduler.update_difficulty(
            self.global_step // self.draws_per_step + 1)
        span = max(1, self.scheduler.max_difficulty - self.scheduler.min_difficulty)
        frac = (d - self.scheduler.min_difficulty) / span
        return float(np.clip(frac, 1.0 / span, 1.0))

    def _pool(self):
        """Eligible sample ids at the current difficulty."""
        frac = self._difficulty_fraction()
        n = max(self.batch_size, int(self.n_samples * frac))
        return self.sorted_index[:min(n, self.n_samples)]

    def _reshuffle(self, pool_size):
        epoch = self._cursor // max(1, pool_size)
        if epoch != self._epoch or self._epoch_perm is None or \
                len(self._epoch_perm) != pool_size:
            rng = np.random.RandomState(self.seed + 1009 * epoch)
            self._epoch_perm = rng.permutation(pool_size)
            self._epoch = epoch

    def next_batch_indices(self):
        """Global-batch sample ids for this step; all ranks agree."""
        pool = self._pool()
        self._reshuffle(len(pool))
        start = self._cursor % len(pool)
        take = self.batch_size
        picks = []
        while take > 0:
            chunk = self._epoch_perm[start:start + take]
            picks.append(chunk)
            take -= len(chunk)
            self._cursor += len(chunk)  # advance by exactly what was consumed
            if take > 0:  # wrap epoch
                self._reshuffle(len(pool))
                start = 0
        self.global_step += 1
        ids = pool[np.concatenate(picks)]
        return ids

    def next_local_indices(self):
        """This dp rank's share of the step's global batch."""
        ids = self.next_batch_indices()
        per = self.batch_size // self.dp_size
        return ids[self.dp_rank * per:(self.dp_rank + 1) * per]

    def __iter__(self):
        while True:
            yield self.next_local_indices()

    def state_dict(self):
        return {"global_step": self.global_step, "cursor": self._cursor,
                "seed": self.seed}

    def load_state_dict(self, state):
        self.global_step = state["global_step"]
        self._cursor = state["cursor"]
        self.seed = state["seed"]
        self._epoch_perm = None
        self._epoch = -1
