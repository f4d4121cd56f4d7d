"""Compressed collectives: the flat qgZ schedule (counterpart of
``deeperspeed_tpu/comm/compressed.py``).

ZeRO++ quantized gradient reduction (reference
``runtime/comm/coalesced_collectives.py:31`` ``all_to_all_quant_reduce``):
1-byte block-scaled payloads (int8, or fp8 e5m2 for gradients) plus one
fp32 scale per group on the wire, summed locally in fp32 by kernel B5.
The JAX functions are traced inside ``shard_map``; these are eager calls on
a process group, in the same order on the same values, so for equal
per-rank inputs they give the JAX package's bits.

Not ported yet (ROADMAP Queue A, 'Multi-process training, part 2'): the
two-level (hierarchical) schedule, which the facade refuses
(``comm.all_reduce_quantized`` with ``intra_group`` / ``inter_group``), and
the 1-bit compressed all-reduce.
"""

import torch

from ..ops.quantizer import fused_dequant_reduce
from ..quantization import BlockScaledTensor, group_shape
from .comm import all_gather, all_to_all


def quantized_reduce_scatter(x, group, group_size=128, impl="auto", wire_dtype="int8"):
    """Reduce-scatter with a 1-byte block-scaled wire format.

    ``x``: [m, ...] with m divisible by the group size n.  Returns this
    rank's fp32 chunk [m/n, ...] of the group sum: the payload and its
    scales go through one all-to-all each, and B5 sums the n peers' copies
    of the chunk in peer order where the chunks keep whole groups."""
    n = group.size()
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) not divisible by {n}")
    t = BlockScaledTensor.quantize(x, wire_dtype, group_size)
    qt = all_to_all(t.values, group)
    st = all_to_all(t.scales, group)
    qn = qt.reshape(n, x.shape[0] // n, *x.shape[1:])
    g = group_shape(qn.shape[-1], group_size)
    if st.numel() * g == qt.numel():
        sn = st.reshape(n, x.shape[0] // n, *st.shape[1:])
        return fused_dequant_reduce(BlockScaledTensor(qn, sn, group_size), impl=impl)
    deq = BlockScaledTensor(qt, st, group_size).dequantize(torch.float32)
    return deq.reshape(n, x.shape[0] // n, *x.shape[1:]).sum(0)


def quantized_all_gather(x, group, group_size=128, dtype=torch.float32,
                         wire_dtype="int8"):
    """All-gather (tiled along dim 0) with a block-scaled wire format:
    quantize, gather payload and scales, dequantize to ``dtype``."""
    t = BlockScaledTensor.quantize(x, wire_dtype, group_size)
    return BlockScaledTensor(all_gather(t.values, group), all_gather(t.scales, group),
                             group_size).dequantize(dtype)


def quantized_all_reduce(x, group, group_size=128, impl="auto", wire_dtype="int8"):
    """Flat quantized all-reduce: the quantized reduce-scatter, then the
    quantized all-gather of the reduced chunk (requantized)."""
    shard = quantized_reduce_scatter(x, group, group_size, impl=impl,
                                     wire_dtype=wire_dtype)
    return quantized_all_gather(shard, group, group_size, dtype=torch.float32,
                                wire_dtype=wire_dtype).to(x.dtype)
