"""Groupwise quantization for ZeRO++ communication compression
(counterpart of ``deeperspeed_tpu/runtime/zero/quantized.py``), over the
port's :class:`~deeperspeed_tpu_torch.quantization.BlockScaledTensor`.

* qgZ (quantized gradients): :func:`qgz_reduce_scatter` and
  :func:`qgz_all_reduce` run the two-hop schedule of ``comm/compressed.py``
  when both an intra and an inter group span more than one process, and
  the flat one over the group that does otherwise; each adds its analytic
  wire bytes to the step the engine records (``comm.comm._run_quantized``,
  shared with the facade).
* qwZ (quantized weights, ``zero_quantized_weights`` at stage 3):
  :func:`quantized_all_gather_partition` gathers a stage-3 region's
  partition with int8 values and fp32 scales on the wire, dequantized to
  the compute type.  The JAX package quantizes before an XLA resharding
  (``quantized_resharding``) and so differentiates through the int8 cast,
  which passes no gradient: its gradient reaches only the element that
  sets each group's scale.  Here the int8 is a forward wire format only,
  as the JAX engine's comment and ZeRO++'s quantized
  ``all_gather_coalesced`` mean it: the backward pass is the plain
  gather's (``zero/stage3.py``).
"""

import math

import torch

from ...quantization import BlockScaledTensor
from ...quantization import group_shape as _group_shape  # noqa: F401 (re-export)


def quantize_int8(x, group_size=128):
    """Symmetric per-group int8 along the last dim: ``(q int8 [..., d],
    fp32 scale [..., d/group, 1])`` with ``x ~= q * scale``."""
    t = BlockScaledTensor.quantize(x, "int8", group_size)
    return t.values, t.scales


def dequantize_int8(q, scale, dtype=torch.bfloat16, group_size=128):
    return BlockScaledTensor(q, scale, group_size).dequantize(dtype)


def qgz_reduce_scatter(x, intra_group=None, inter_group=None, group_size=128,
                       impl="auto", wire_dtype="int8"):
    """ZeRO++ qgZ gradient reduce-scatter: the two-hop schedule (quantize,
    intra reduce-scatter, requantize, inter reduce-scatter) when both groups
    span more than one process; the flat one over the group that does
    otherwise (``x`` itself when neither does)."""
    from ...comm.comm import _hier_groups, _run_quantized

    intra, inter = _hier_groups(intra_group, inter_group, collapse=True)
    if intra is None:
        return x
    return _run_quantized("reduce_scatter", x, x.numel(), intra, inter, group_size, impl,
                          wire_dtype)


def qgz_all_reduce(x, intra_group=None, inter_group=None, group_size=128,
                   impl="auto", wire_dtype="int8"):
    """ZeRO++ qgZ gradient all-reduce: the reduce-scatter of
    :func:`qgz_reduce_scatter`, then quantized all-gathers back (inter
    first); the same rule picks the two-hop or the flat schedule."""
    from ...comm.comm import _hier_groups, _run_quantized

    intra, inter = _hier_groups(intra_group, inter_group, collapse=True)
    if intra is None:
        return x
    return _run_quantized("all_reduce", x, x.numel(), intra, inter, group_size, impl,
                          wire_dtype)


def fused_flat_reduce(leaves, reduce_fn, divisor=1.0):
    """Reduce a list of tensors as one flattened collective: concatenate
    them (each divided by ``divisor``), apply ``reduce_fn`` once, and split
    the result back into their shapes.  Elementwise reductions commute with
    concatenation, so an exact collective gives the per-leaf values; a
    quantized one draws its groups across the leaves' edges."""
    flat = torch.cat([(leaf / divisor).reshape(-1) for leaf in leaves])
    flat = reduce_fn(flat)
    return [piece.view(leaf.shape) for leaf, piece in
            zip(leaves, flat.split([leaf.numel() for leaf in leaves]))]


def quantized_all_gather_partition(shard, group, group_size=128,
                                   log_name="stage3_gather_qwz"):
    """qwZ: every rank's flat ``shard`` (its partition of a region, all of
    one length), gathered whole in rank order with int8 values and one fp32
    scale per ``group_size`` elements on the wire, dequantized to
    ``shard``'s dtype.  Each partition is zero-padded to whole groups
    before it is quantized; the padding is dropped after the gather."""
    from ...comm import all_gather

    part = shard.numel()
    rows = math.ceil(part / group_size)
    padded = torch.nn.functional.pad(shard.reshape(-1), (0, rows * group_size - part))
    t = BlockScaledTensor.quantize(padded.reshape(rows, group_size), "int8", group_size)
    values = all_gather(t.values, group, log_name=log_name)
    scales = all_gather(t.scales, group, log_name=log_name)
    full = BlockScaledTensor(values, scales, group_size).dequantize(shard.dtype)
    n = values.shape[0] // rows
    return full.reshape(n, rows * group_size)[:, :part].reshape(-1)
