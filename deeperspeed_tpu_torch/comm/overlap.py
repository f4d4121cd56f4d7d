"""The comm-overlap layer (counterpart of ``deeperspeed_tpu/comm/overlap.py``;
config surface ``comm.overlap`` in ``runtime/config.py``):

* :func:`bucketize`: contiguous groups of leaves of at most ``bucket_mb``
  MiB, for a once-per-batch gradient reduction issued bucket by bucket;
* :class:`AsyncOpHandle`: what an eager collective called with
  ``async_op=True`` returns under ``comm.overlap.eager_async``, over
  torch's ``Work``;
* :func:`apply_xla_latency_hiding` and :func:`effective_latency_hiding_flags`,
  the JAX package's table of XLA latency-hiding flags.  They are TPU
  compiler flags with nothing to set on the card: here they do what the
  JAX functions do when the process does not target a TPU -- one warning,
  nothing appended.
"""

from ..utils.logging import logger


def apply_xla_latency_hiding(env=None):
    """The JAX function's answer off a TPU: a warning, and no flag appended
    (returns ``[]``)."""
    logger.warning(
        "comm.overlap.xla_latency_hiding: not targeting TPU; the "
        "latency-hiding flags are libtpu flags with no counterpart on the "
        "card. Skipping.")
    return []


def effective_latency_hiding_flags(env=None):
    """The latency-hiding flags in effect: none on the card."""
    return []


def bucketize(nbytes_per_leaf, bucket_mb):
    """Greedy contiguous grouping of leaf indices into ~``bucket_mb`` MiB
    buckets.

    Returns a list of index lists covering ``range(len(nbytes_per_leaf))``
    in order.  ``bucket_mb <= 0`` means one bucket.  A leaf larger than the
    budget gets its own bucket (a leaf is never split)."""
    n = len(nbytes_per_leaf)
    if bucket_mb <= 0 or n == 0:
        return [list(range(n))] if n else []
    budget = float(bucket_mb) * (1 << 20)
    buckets, cur, cur_bytes = [], [], 0.0
    for i, b in enumerate(nbytes_per_leaf):
        if cur and cur_bytes + b > budget:
            buckets.append(cur)
            cur, cur_bytes = [], 0.0
        cur.append(i)
        cur_bytes += b
    if cur:
        buckets.append(cur)
    return buckets


class AsyncOpHandle:
    """torch-``Work``-alike for an eager collective issued without
    blocking: ``wait()`` waits for the collective (``work``, None when it
    already finished), runs ``finish`` (for gloo on CUDA tensors, the copy
    of the host result back to the card) and returns the result."""

    def __init__(self, work, finish):
        self._work, self._finish = work, finish
        self._done, self._value = False, None

    def wait(self):
        if not self._done:
            if self._work is not None:
                self._work.wait()
            self._value = self._finish()
            self._done = True
        return self._value

    # torch.distributed.Work compat aliases
    def result(self):
        return self.wait()

    def is_completed(self):
        return self._done or self._work is None or self._work.is_completed()
