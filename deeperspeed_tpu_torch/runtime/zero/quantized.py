"""Groupwise quantization for ZeRO++ communication compression
(counterpart of ``deeperspeed_tpu/runtime/zero/quantized.py``), over the
port's :class:`~deeperspeed_tpu_torch.quantization.BlockScaledTensor`.

The qgZ wrappers run the flat schedule of ``comm/compressed.py`` over one
process group.  The two-hop form (an intra and an inter group both above
one process) raises ``NotImplementedError`` (ROADMAP Queue A,
'Multi-process training, part 2'); qwZ's ``quantized_resharding`` comes
with it.
"""

import torch

from ...quantization import BlockScaledTensor
from ...quantization import group_shape as _group_shape  # noqa: F401 (re-export)

_PART2 = "(ROADMAP Queue A, 'Multi-process training, part 2')"


def quantize_int8(x, group_size=128):
    """Symmetric per-group int8 along the last dim: ``(q int8 [..., d],
    fp32 scale [..., d/group, 1])`` with ``x ~= q * scale``."""
    t = BlockScaledTensor.quantize(x, "int8", group_size)
    return t.values, t.scales


def dequantize_int8(q, scale, dtype=torch.bfloat16, group_size=128):
    return BlockScaledTensor(q, scale, group_size).dequantize(dtype)


def _one_group(intra_group, inter_group):
    """The single group of a flat schedule; two groups above one process
    each need the two-hop schedule."""
    sizes = [g.size() if g is not None else 1 for g in (intra_group, inter_group)]
    if min(sizes) > 1:
        raise NotImplementedError(
            f"the two-hop qgZ schedule is not ported yet {_PART2}")
    return intra_group if sizes[0] > 1 else inter_group


def qgz_reduce_scatter(x, intra_group=None, inter_group=None, group_size=128,
                       impl="auto", wire_dtype="int8"):
    """ZeRO++ qgZ gradient reduce-scatter over one group (the flat path of
    the JAX function: one group given, or the other of size 1)."""
    from ...comm.compressed import quantized_reduce_scatter

    group = _one_group(intra_group, inter_group)
    if group is None or group.size() == 1:
        return x
    return quantized_reduce_scatter(x, group, group_size, impl=impl,
                                    wire_dtype=wire_dtype)


def qgz_all_reduce(x, intra_group=None, inter_group=None, group_size=128,
                   impl="auto", wire_dtype="int8"):
    """ZeRO++ qgZ gradient all-reduce over one group: the quantized
    reduce-scatter, then quantized all-gathers back."""
    from ...comm.compressed import quantized_all_reduce

    group = _one_group(intra_group, inter_group)
    if group is None or group.size() == 1:
        return x
    return quantized_all_reduce(x, group, group_size, impl=impl, wire_dtype=wire_dtype)


def fused_flat_reduce(leaves, reduce_fn, divisor=1.0):
    """Reduce a list of tensors as one flattened collective: concatenate
    them (each divided by ``divisor``), apply ``reduce_fn`` once, and split
    the result back into their shapes.  Elementwise reductions commute with
    concatenation, so an exact collective gives the per-leaf values."""
    flat = torch.cat([(leaf / divisor).reshape(-1) for leaf in leaves])
    flat = reduce_fn(flat)
    return [piece.view(leaf.shape) for leaf, piece in
            zip(leaves, flat.split([leaf.numel() for leaf in leaves]))]
