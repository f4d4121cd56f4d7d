"""Block-scaled quantization for the paged KV cache, int8 or fp8 e4m3
(counterpart of ``deeperspeed_tpu/ops/quantizer/kv.py``).

The KV pool stores :class:`~deeperspeed_tpu_torch.quantization.BlockScaledTensor`
row-layout pairs, specialized for the pool geometry:

* group = one head's value vector (``head_dim`` elements), i.e. one fp32
  scale per (pool slot, head) -- stored blockwise alongside the pool as
  ``[num_blocks, block_size, num_heads]``, so the decode kernel fetches a
  token's scale through the same block-table indirection as its 1-byte
  payload;
* scales in fp32: the scale rides the attention accumulation in fp32
  anyway, and costs 4 bytes per ``head_dim`` payload bytes.

Quantize-on-write happens in the model's scatter (token granularity, which
is exactly one group per head); the pool never holds fp values, and
dequantization happens inside the attention kernel's token walk
(``csrc/paged_attention.cu``) or after the prefill gather.  These two are
plain tensor ops, as they are plain XLA ops in the JAX package.
"""

import torch

from ...quantization import BlockScaledTensor


def quantize_kv(x, dtype="int8"):
    """Per-(token, head) symmetric quantization along the trailing dim.

    ``x`` [..., D] -> (``q`` [..., D] in ``dtype`` (int8 / fp8_e4m3),
    ``scale`` fp32 [...]) with ``x ~= q * scale[..., None]``.
    """
    return BlockScaledTensor.quantize_rows(x, dtype)


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv`: ``q`` [..., D] * ``scale``
    [...] -> [..., D] in ``dtype``."""
    return BlockScaledTensor.dequantize_rows(q, scale, dtype)


def byte_view(t):
    """A 1-byte tensor as uint8 (a reinterpretation, no copy), any other
    tensor as it is: the float8 types lack index kernels, and a pool's
    scatter, gather and block copy only move bytes."""
    return t.view(torch.uint8) if t.element_size() == 1 else t
