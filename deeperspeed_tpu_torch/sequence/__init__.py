"""Sequence / context parallelism over the mesh's ``sp`` axis (counterpart
of ``deeperspeed_tpu/sequence/``): DeepSpeed-Ulysses' all-to-all pair
around a local attention (``layer.py``), ring attention (``ring.py``), and
the exact exchange of the models' default mode, each rank's queries over
the keys and values of the whole sequence gathered (``layer.py``
:func:`gather_sequence`).

The training engine binds a model to its ``sp`` group
(:func:`bind_sequence_parallel`); a bound model holds a slice of every
sequence, ``[r S / p, (r + 1) S / p)`` on slice ``r`` of ``p``, at the
global positions of those tokens."""

from .layer import (  # noqa: F401
    DistributedAttention,
    SeqAllGather,
    SeqAllToAll,
    bind_sequence_parallel,
    gather_sequence,
    gathered_keys,
    padded_attention,
    sequence_group,
    sequence_positions,
    single_all_to_all,
    ulysses_attention,
)
from .ring import ring_attention, ring_attention_sharded  # noqa: F401
