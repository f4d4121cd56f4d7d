"""Fused dequant-reduce: kernel B5 and its plain version (counterpart of
``deeperspeed_tpu/ops/quantizer/fused.py``).

The qgZ gradient reduce-scatter (``comm/compressed.py``) all-to-alls
1-byte block-scaled payloads (int8 or fp8) and must then compute
``sum_k dequant(q[k], s[k])`` in fp32.  Dequantizing every peer's copy
first would write ``n`` fp32 operands to memory before the sum; B5
(``csrc/dequant_reduce.cu``) reads each 1-byte value and its scale once and
writes the fp32 sum once.

For CUDA tensors :func:`fused_dequant_reduce` launches ``dst_dequant_reduce``
(counted as ``dequant_reduce`` in ``cuda_utils.LAUNCHES``); for CPU tensors
it runs :func:`_dequant_reduce_plain`, the JAX package's
``_xla_dequant_reduce``: peers summed in peer order starting from the first
peer's products, each product and sum rounded on its own.  The two agree
bit for bit, and both equal the JAX package's for the same inputs.

``impl`` keeps the JAX signature: its ``'pallas'`` and ``'xla'`` backends
give the same bits there, so here every value selects the same route (B5 on
the card, the plain version on the CPU).
"""

import torch

from ...accelerator import get_accelerator
from ...quantization import BlockScaledTensor, canonical_dtype, group_shape
from ..cuda_utils import check, library, ptr, require_cuda, stream_of

IMPLS = ("auto", "pallas", "xla")
# value type codes of csrc/dequant_reduce.cu
_QTYPES = {"int8": 0, "fp8_e4m3": 1, "fp8_e5m2": 2}


def _normalize(q, scale, group_size):
    """[n, ...] 1-byte values + one scale per group -> ([n, rows, d],
    [n, rows, groups], g)."""
    if q.dim() < 2:
        raise ValueError(f"expected q [n, ...], got shape {tuple(q.shape)}")
    n, d = q.shape[0], q.shape[-1]
    g = group_shape(d, group_size)
    groups = d // g
    rows = q.numel() // (n * d)
    if scale.numel() != n * rows * groups:
        raise ValueError(f"scale size {scale.numel()} does not match q "
                         f"{tuple(q.shape)} at group {g}")
    return q.reshape(n, rows, d), scale.reshape(n, rows, groups), g


def _dequant_reduce_plain(q3, s3, g):
    """Plain version of B5: ``_xla_dequant_reduce``, peer by peer."""
    def deq(k):
        return BlockScaledTensor(q3[k], s3[k][..., None], g).dequantize(torch.float32)

    acc = deq(0)
    for k in range(1, q3.shape[0]):
        acc = acc + deq(k)
    return acc


def _dequant_reduce_cuda(q3, s3, g):
    """B5 on the card: one launch, fp32 [rows, d]."""
    require_cuda("dequant_reduce", q3, s3)
    if s3.dtype != torch.float32:
        raise TypeError(f"dequant_reduce: scales must be float32, got {s3.dtype}")
    n, rows, d = q3.shape
    out = torch.empty(rows, d, dtype=torch.float32, device=q3.device)
    err = library("dequant_reduce").dst_dequant_reduce(
        ptr(q3), ptr(s3), ptr(out), n, rows, d, g,
        _QTYPES[canonical_dtype(q3.dtype)], stream_of(out))
    check(err, "dequant_reduce")
    return out


def fused_dequant_reduce(q, scale=None, group_size=128, impl="auto"):
    """``sum_k dequant(q[k], scale[k])`` in fp32, shape ``q.shape[1:]``.

    ``q``: a :class:`BlockScaledTensor` of per-peer partials (leading dim =
    peer), or 1-byte values ``[n, ...]`` (int8 / fp8) with ``scale`` holding
    one fp32 scale per group in any layout."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if isinstance(q, BlockScaledTensor):
        q, scale, group_size = q.values, q.scales, q.group_size
    shape = q.shape[1:]
    q3, s3, g = _normalize(q, scale, group_size)
    if get_accelerator(q3.device).use_cuda_kernels():
        out = _dequant_reduce_cuda(q3.contiguous(), s3.contiguous(), g)
    else:
        out = _dequant_reduce_plain(q3, s3, g)
    return out.reshape(shape)
