"""Offline per-sample difficulty metrics for curriculum sampling (a copy of
``deeperspeed_tpu/runtime/data_pipeline/data_sampling/data_analyzer.py``,
numpy only).

Equivalent of reference
``runtime/data_pipeline/data_sampling/data_analyzer.py`` (417 LoC): walk a
dataset once, compute a metric per sample (seqlen, vocab rarity, or a
user-provided function), and persist ``metric_value`` plus a
``metric_sorted_index`` permutation that the curriculum sampler consumes.
"""

import os

import numpy as np


def seqlen_metric(sample):
    return len(sample)


def vocab_rarity_metric_factory(vocab_size):
    """Mean negative-log-frequency of a sample's tokens (two-pass)."""
    counts = np.ones(vocab_size, np.float64)

    def accumulate(sample):
        idx, c = np.unique(np.asarray(sample, np.int64), return_counts=True)
        counts[idx] += c

    def metric(sample):
        freqs = counts[np.asarray(sample, np.int64)] / counts.sum()
        return float(-np.log(freqs).mean())

    return accumulate, metric


class DataAnalyzer:
    def __init__(self, dataset, metric_fn=seqlen_metric, save_path=None,
                 metric_name="seqlen"):
        self.dataset = dataset
        self.metric_fn = metric_fn
        self.save_path = save_path
        self.metric_name = metric_name

    def run(self):
        """Returns (values [n], sorted_index [n] ascending difficulty)."""
        values = np.asarray([self.metric_fn(self.dataset[i])
                             for i in range(len(self.dataset))], np.float64)
        order = np.argsort(values, kind="stable")
        if self.save_path:
            os.makedirs(self.save_path, exist_ok=True)
            np.save(os.path.join(self.save_path,
                                 f"{self.metric_name}_metric_value.npy"), values)
            np.save(os.path.join(self.save_path,
                                 f"{self.metric_name}_sorted_index.npy"), order)
        return values, order

    @staticmethod
    def load(save_path, metric_name="seqlen"):
        values = np.load(os.path.join(save_path, f"{metric_name}_metric_value.npy"))
        order = np.load(os.path.join(save_path, f"{metric_name}_sorted_index.npy"))
        return values, order


class DistributedDataAnalyzer(DataAnalyzer):
    """Map/reduce analyzer for real pretraining corpora.

    Equivalent of the reference's multi-worker analyzer
    (``data_analyzer.py:180`` ``run_map`` / ``:411`` ``run_reduce``): N
    workers each map a contiguous shard of the dataset (optionally with
    local threads via multiprocessing), persisting per-shard chunk files;
    one reduce pass merges the chunks into the canonical
    ``{metric}_metric_value.npy`` + ``{metric}_sorted_index.npy`` the
    curriculum sampler consumes, plus a ``metric_to_sample`` grouping
    (sample ids bucketed by metric value -- the reference's
    ``merge_metric_to_sample`` index files).

    Workers are independent processes/jobs: ``run_map`` is safe to launch
    once per worker on disjoint ``worker_id``s against a shared
    filesystem; any single process may then call ``run_reduce``.
    """

    def __init__(self, dataset, metric_fn=seqlen_metric, save_path=None,
                 metric_name="seqlen", num_workers=1, worker_id=0,
                 num_threads=1):
        super().__init__(dataset, metric_fn=metric_fn, save_path=save_path,
                         metric_name=metric_name)
        assert save_path, "DistributedDataAnalyzer needs save_path"
        assert 0 <= worker_id < num_workers
        self.num_workers = num_workers
        self.worker_id = worker_id
        self.num_threads = max(1, num_threads)

    # ---- shard algebra (reference ``utils.split_dataset``/``split_index``)
    @staticmethod
    def _split(n, parts, idx):
        base, rem = divmod(n, parts)
        start = idx * base + min(idx, rem)
        return start, start + base + (1 if idx < rem else 0)

    def _chunk_path(self, worker_id, thread_id):
        return os.path.join(
            self.save_path,
            f"{self.metric_name}_worker{worker_id}_thread{thread_id}.npz")

    def _map_range(self, start, end, out_path):
        values = np.asarray([self.metric_fn(self.dataset[i])
                             for i in range(start, end)], np.float64)
        np.savez(out_path, start=start, end=end, values=values)

    def run_map(self):
        """Compute this worker's shard; one chunk file per local thread."""
        import glob

        os.makedirs(self.save_path, exist_ok=True)
        # stale chunks from a previous run (e.g. a different thread count)
        # would be silently merged by run_reduce -- clear this worker's
        # namespace first
        for old in glob.glob(self._chunk_path(self.worker_id, 0).replace(
                "thread0", "thread*")):
            os.remove(old)
        w0, w1 = self._split(len(self.dataset), self.num_workers,
                             self.worker_id)
        if self.num_threads == 1:
            self._map_range(w0, w1, self._chunk_path(self.worker_id, 0))
            return
        from multiprocessing import get_context

        ctx = get_context("fork")
        procs = []
        for t in range(self.num_threads):
            t0, t1 = self._split(w1 - w0, self.num_threads, t)
            p = ctx.Process(target=self._map_range,
                            args=(w0 + t0, w0 + t1,
                                  self._chunk_path(self.worker_id, t)))
            p.start()
            procs.append(p)
        for p in procs:
            p.join()
            if p.exitcode != 0:
                raise RuntimeError(
                    f"analyzer map thread failed (exit {p.exitcode})")

    def run_reduce(self):
        """Merge every worker's chunk files into the canonical outputs."""
        n = len(self.dataset)
        values = np.full(n, np.nan, np.float64)
        for w in range(self.num_workers):
            t = 0
            while os.path.isfile(self._chunk_path(w, t)):
                chunk = np.load(self._chunk_path(w, t))
                values[int(chunk["start"]):int(chunk["end"])] = chunk["values"]
                t += 1
            if t == 0:
                raise FileNotFoundError(
                    f"no map chunks for worker {w} under {self.save_path}; "
                    "did every worker run run_map()?")
        missing = np.flatnonzero(np.isnan(values))
        if missing.size:
            raise ValueError(
                f"{missing.size} samples unmapped (first: {missing[:5]}); "
                "worker shards incomplete")
        order = np.argsort(values, kind="stable")
        np.save(os.path.join(self.save_path,
                             f"{self.metric_name}_metric_value.npy"), values)
        np.save(os.path.join(self.save_path,
                             f"{self.metric_name}_sorted_index.npy"), order)
        # metric -> sample-id buckets (reference merge_metric_to_sample),
        # vectorized: unique metric values + the stable sort order give each
        # bucket as a contiguous slice of ``order``
        uniq, counts = np.unique(values, return_counts=True)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        np.savez(os.path.join(self.save_path,
                              f"{self.metric_name}_metric_to_sample.npz"),
                 metric_values=uniq,
                 sample_ids=order.astype(np.int64),
                 bucket_offsets=offsets.astype(np.int64))
        return values, order
