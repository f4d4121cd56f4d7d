"""Weight-only quantization for the v1 engine (``quant`` in the config;
counterpart of ``deeperspeed_tpu/inference/quantization.py``).

Weights are stored groupwise-quantized -- int8, or int4 packed two to a
byte with the low nibble first -- with one bf16 scale a group of
``group_size`` elements along the last dim, and dequantized where they are
used.  The JAX package transforms its parameter tree and dequantizes it
inside each compiled call; here:

* :func:`quantize_param_tree` / :func:`dequantize_param_tree` do the same
  to a tree (nested dicts) of tensors, a :class:`QuantizedWeight` per
  quantized leaf;
* :func:`quantize_module` quantizes a model in place: each ``nn.Linear`` or
  ``nn.Embedding`` (or its tensor-parallel form) whose weight qualifies
  keeps ``weight_q`` and ``weight_scale`` buffers instead of its weight,
  and dequantizes its own weight in the compute type at each use (reading
  ``.weight``), so one layer's full-precision weight is alive at a time,
  never the whole model's.

A leaf qualifies when it is floating, has at least two dims and at least
``min_size`` elements (and, for int4, an even last dim): norms and biases
stay exact.  Groups run along the last dim of the JAX package's layout:
a ``Dense`` kernel is [in, out], the transpose of ``nn.Linear.weight``, so
a Linear is quantized as ``weight.t()`` and gives the JAX package's q and
scales bit for bit.  The scale is ``amax / n + 1e-12`` (n = 127 or 7)
rounded to bf16 as the JAX function computes it under ``jit``: XLA turns
the division by the constant into a product with its fp32 reciprocal and
fuses the sum into one multiply-add, rounded once.
"""

import dataclasses

import numpy as np
import torch
from torch import nn

from ..parallel.tensor_parallel import (ColumnParallelLinear, RowParallelLinear,
                                        VocabParallelEmbedding)

_EPS = float(np.float32(1e-12))
_LINEAR = (nn.Linear, ColumnParallelLinear, RowParallelLinear)
_EMBEDDING = (nn.Embedding, VocabParallelEmbedding)


@dataclasses.dataclass
class QuantizedWeight:
    """One weight's storage: ``q`` int8 (or packed int4 in uint8) and
    ``scale`` bf16 [..., d / group, 1]; ``shape`` and ``dtype`` are the
    weight's."""

    q: torch.Tensor
    scale: torch.Tensor
    bits: int = 8
    group: int = 64
    shape: tuple = ()
    dtype: torch.dtype = torch.bfloat16


def _qualifies(w, bits, min_size):
    return (isinstance(w, torch.Tensor) and w.is_floating_point() and w.dim() >= 2
            and w.numel() >= min_size and (bits != 4 or w.shape[-1] % 2 == 0))


def quantize_weight(w, bits=8, group_size=64) -> QuantizedWeight:
    """Groupwise quantization of ``w`` along its last dim (one group of
    the whole dim when ``group_size`` does not divide it)."""
    if bits not in (4, 8):
        raise ValueError(f"wq bits must be 4 or 8, got {bits}")
    d = w.shape[-1]
    g = group_size if (group_size > 0 and d % group_size == 0) else d
    grouped = w.to(torch.float32).reshape(*w.shape[:-1], d // g, g)
    n = 2.0 ** (bits - 1) - 1.0
    amax = grouped.abs().amax(dim=-1, keepdim=True)
    recip = float(np.float32(1.0 / n))
    scale = (amax.to(torch.float64) * recip + _EPS).to(torch.float32).to(torch.bfloat16)
    q = torch.clamp(torch.round(grouped / scale.to(torch.float32)), -n - 1, n)
    q = q.to(torch.int8).reshape(w.shape)
    if bits == 4:
        q4 = q.reshape(*w.shape[:-1], d // 2, 2)
        q = ((q4[..., 0] & 0x0F) | ((q4[..., 1] & 0x0F) << 4)).to(torch.uint8)
    return QuantizedWeight(q, scale, bits, g, tuple(w.shape), w.dtype)


def dequantize_weight(leaf: QuantizedWeight, dtype=None):
    """The weight back in ``dtype`` (the weight's own type by default); an
    int4 nibble is sign-extended."""
    q = leaf.q
    if leaf.bits == 4:
        lo = (q & 0x0F).to(torch.int8)
        hi = ((q >> 4) & 0x0F).to(torch.int8)
        lo = torch.where(lo >= 8, lo - 16, lo)
        hi = torch.where(hi >= 8, hi - 16, hi)
        q = torch.stack([lo, hi], dim=-1).reshape(leaf.shape)
    d = leaf.shape[-1]
    grouped = q.to(torch.float32).reshape(*leaf.shape[:-1], d // leaf.group, leaf.group)
    out = grouped * leaf.scale.to(torch.float32)
    return out.reshape(leaf.shape).to(dtype or leaf.dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def quantize_param_tree(params, bits=8, group_size=64, min_size=4096):
    """Every qualifying leaf of ``params`` (nested dicts of tensors, in the
    JAX package's layout) as a :class:`QuantizedWeight`; the others as they
    are."""
    if bits not in (4, 8):
        raise ValueError(f"wq bits must be 4 or 8, got {bits}")
    return _map(params, lambda w: quantize_weight(w, bits, group_size)
                if _qualifies(w, bits, min_size) else w)


def dequantize_param_tree(params, dtype=None):
    """The inverse of :func:`quantize_param_tree`, in ``dtype``."""
    return _map(params, lambda x: dequantize_weight(x, dtype)
                if isinstance(x, QuantizedWeight) else x)


def _dequantized(mod):
    """The ``weight`` of a quantized layer: dequantized at each read, in
    the layer's layout."""
    w = dequantize_weight(QuantizedWeight(mod.weight_q, mod.weight_scale, *mod.wq_meta))
    return w.t() if isinstance(mod, _LINEAR) else w


_CLASSES = {}


def _quantized_class(cls):
    if cls not in _CLASSES:
        _CLASSES[cls] = type(f"Quantized{cls.__name__}", (cls,),
                             {"weight": property(_dequantized), "__module__": __name__})
    return _CLASSES[cls]


def quantize_module(module, bits=8, group_size=64, min_size=4096):
    """Quantize ``module``'s Linear and Embedding weights in place (see the
    module docstring); returns the number of layers quantized."""
    if bits not in (4, 8):
        raise ValueError(f"wq bits must be 4 or 8, got {bits}")
    count = 0
    for mod in list(module.modules()):
        w = mod._parameters.get("weight")
        if not isinstance(mod, _LINEAR + _EMBEDDING) or w is None:
            continue
        # the JAX layout: a Dense kernel is [in, out]
        ref = w.detach().t() if isinstance(mod, _LINEAR) else w.detach()
        if not _qualifies(ref, bits, min_size):
            continue
        qw = quantize_weight(ref, bits, group_size)
        del mod._parameters["weight"]
        mod.register_buffer("weight_q", qw.q)
        mod.register_buffer("weight_scale", qw.scale)
        mod.wq_meta = (qw.bits, qw.group, qw.shape, qw.dtype)
        mod.__class__ = _quantized_class(type(mod))
        count += 1
    return count


def quantized_bytes(params):
    """Storage bytes of a (possibly quantized) tree, or of a module's
    parameters and buffers."""
    if isinstance(params, nn.Module):
        return sum(t.numel() * t.element_size()
                   for t in list(params.parameters()) + list(params.buffers()))
    total = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, QuantizedWeight):
            total += node.q.numel() * node.q.element_size()
            total += node.scale.numel() * node.scale.element_size()
        elif isinstance(node, torch.Tensor):
            total += node.numel() * node.element_size()
    return total
