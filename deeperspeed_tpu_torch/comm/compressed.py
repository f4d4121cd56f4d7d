"""Compressed collectives: quantized gradient reduction and the 1-bit
all-reduce (counterpart of ``deeperspeed_tpu/comm/compressed.py``).

* :func:`quantized_reduce_scatter` / :func:`quantized_all_reduce`: the
  flat qgZ schedule of ZeRO++ (reference
  ``runtime/comm/coalesced_collectives.py:31`` ``all_to_all_quant_reduce``):
  1-byte block-scaled payloads (int8, or fp8 e5m2 for gradients) plus one
  fp32 scale per group on the wire, summed locally in fp32 by kernel B5;
* :func:`hierarchical_quantized_reduce_scatter` /
  :func:`hierarchical_quantized_all_reduce`: the two-level schedule --
  quantize, intra-group reduce-scatter (B5 sums the intra peers),
  requantize, inter-group reduce-scatter (B5 again), then the quantized
  all-gathers back, inter first;
* :func:`onebit_all_reduce`: 1-bit Adam's error-feedback sign compression
  (reference ``runtime/comm/nccl.py:51`` ``compressed_allreduce``): signs
  packed 8 to a byte and one fp32 scale a rank, both all-gathered.

The JAX functions are traced inside ``shard_map``; these are eager calls on
process groups, in the same order on the same values, so for equal
per-rank inputs the quantized ones give the JAX package's bits.  Only B5
is a kernel here: the rest is plain PyTorch, as it is plain ``jnp`` there.
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


def hierarchical_quantized_reduce_scatter(x, intra_group, inter_group, group_size=128,
                                          impl="auto", wire_dtype="int8"):
    """Two-level qgZ reduce-scatter: quantize, intra-group reduce-scatter,
    requantize, inter-group reduce-scatter.  ``x``: [m, ...] with m
    divisible by ``n_intra * n_inter``; participant ``(i_intra, i_inter)``
    returns fp32 global chunk ``i_intra * n_inter + i_inter`` of shape
    [m / (n_intra n_inter), ...].  The inter hop moves only the intra hop's
    reduced ``1 / n_intra`` of the payload."""
    shard = quantized_reduce_scatter(x, intra_group, group_size, impl=impl,
                                     wire_dtype=wire_dtype)
    return quantized_reduce_scatter(shard, inter_group, group_size, impl=impl,
                                    wire_dtype=wire_dtype)


def hierarchical_quantized_all_reduce(x, intra_group, inter_group, group_size=128,
                                      impl="auto", wire_dtype="int8"):
    """Two-level qgZ all-reduce: the two-level reduce-scatter, then the
    quantized all-gathers back, inter first and intra last (the reverse
    order restores the chunk layout)."""
    shard = hierarchical_quantized_reduce_scatter(x, intra_group, inter_group, group_size,
                                                  impl=impl, wire_dtype=wire_dtype)
    part = quantized_all_gather(shard, inter_group, group_size, wire_dtype=wire_dtype)
    return quantized_all_gather(part, intra_group, group_size,
                                wire_dtype=wire_dtype).to(x.dtype)


_BITS = torch.arange(8, dtype=torch.uint8)


def _pack_signs(bits):
    """bool [..., 8k] -> uint8 [..., k] (bit i of a byte is element i)."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.uint8)
    return (b << _BITS.to(b.device)).sum(-1, dtype=torch.int32).to(torch.uint8)


def _unpack_signs(packed, n):
    """uint8 [..., k] -> float32 in {-1, +1} [..., n] (n <= 8k)."""
    bits = (packed[..., None] >> _BITS.to(packed.device)) & 1
    signs = bits.to(torch.float32) * 2.0 - 1.0
    return signs.reshape(*packed.shape[:-1], packed.shape[-1] * 8)[..., :n]


def onebit_all_reduce(x, group, error=None):
    """Error-feedback sign-compressed mean all-reduce (1-bit Adam).

    Returns ``(mean estimate, new error)``; feed the error back on the next
    call.  Each rank puts ``ceil(n/8)`` sign bytes and one fp32 scale on the
    wire, all-gathered (``4n`` bytes a rank for an fp32 ring all-reduce)."""
    from .comm import all_gather

    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    c = flat if error is None else flat + error.reshape(-1)
    scale = c.abs().mean()
    bits = c >= 0
    new_error = c - scale * (bits.to(torch.float32) * 2.0 - 1.0)
    packed = _pack_signs(torch.nn.functional.pad(bits, (0, (-n) % 8)))
    all_packed = all_gather(packed, group, tiled=False,
                            log_name="onebit_all_gather")           # [world, n/8]
    all_scales = all_gather(scale.reshape(1), group,
                            log_name="onebit_all_gather")           # [world]
    signs = _unpack_signs(all_packed, n)                            # [world, n]
    result = (all_scales[:, None] * signs).sum(0) / all_scales.shape[0]
    return result.reshape(x.shape).to(x.dtype), new_error.reshape(x.shape)
