"""Attention dispatch (counterpart of ``deeperspeed_tpu/ops/attention/core.py``).

On the card, an unmasked call without dropout whose shape and dtype the
flash kernels take (fp32/bf16, D % 8 == 0) and whose q and k shapes agree
goes to :func:`flash.flash_attention` (kernels K5-K7), the rule of the JAX
package's ``dot_product_attention`` on the TPU.  Everything else, and every
call on the CPU (where the JAX package takes its reference path too), is
the dense path: two products and a softmax, left to ``torch.matmul``-class
operators as the JAX package left it to XLA.  Serving prefill passes a
mask, so it takes the dense path, as it does in the JAX package.

Attention dropout (training with ``dropout_rate > 0``) lives on the dense
path only, as in the JAX package, whose flash kernels have none: the
probabilities, cast to q's type, keep each entry with probability
1 - rate and are scaled by 1 / (1 - rate).  The keep mask is drawn from the
caller's ``torch.Generator`` (uniforms below 1 - rate, ``bernoulli``'s
rule), never from the default generators.
"""

import math

import torch

from ...accelerator import get_accelerator
from .flash import flash_attention, flash_attention_supported


def _scale_for(q):
    # 1 / sqrt(D) rounded through q's type, as the reference computes it
    root = torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32).to(q.dtype)
    return float(1.0 / root)


def keep_mask(shape, rate, generator, device):
    """Bool [shape]: True with probability 1 - ``rate``, from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u < 1.0 - rate


def _reference_attention(q, k, v, mask=None, causal=True, scale=None,
                         dropout_rate=0.0, generator=None):
    """Scores and softmax in fp32; probabilities cast back to q's type
    before the product with v.  ``mask`` broadcasts to [B, N, Sq, Sk]."""
    seq_q, seq_k = q.shape[-3], k.shape[-3]
    if scale is None:
        scale = _scale_for(q)
    logits = torch.einsum("bqnd,bknd->bnqk", q, k).to(torch.float32) * scale
    fill = torch.finfo(torch.float32).min
    if causal:
        causal_mask = torch.ones(seq_q, seq_k, dtype=torch.bool,
                                 device=q.device).tril(seq_k - seq_q)
        logits = logits.masked_fill(~causal_mask, fill)
    if mask is not None:
        logits = logits.masked_fill(~mask, fill)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_rate > 0.0 and generator is not None:
        keep = keep_mask(probs.shape, dropout_rate, generator, probs.device)
        probs = probs * keep / (1.0 - dropout_rate)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def dot_product_attention(q, k, v, mask=None, causal=True, scale=None,
                          dropout_rate=0.0, generator=None):
    """Multi-head attention over [batch, seq, heads, head_dim] tensors;
    dropout on the probabilities when ``dropout_rate > 0`` and a
    ``generator`` is given."""
    if (get_accelerator(q.device).use_cuda_kernels() and mask is None
            and dropout_rate == 0.0):
        if flash_attention_supported(q.shape, q.dtype) and q.shape == k.shape:
            return flash_attention(q, k, v, causal=causal, scale=scale)
    return _reference_attention(q, k, v, mask=mask, causal=causal, scale=scale,
                                dropout_rate=dropout_rate, generator=generator)
