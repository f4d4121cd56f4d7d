"""Plain masked attention (counterpart of ``deeperspeed_tpu/ops/attention/core.py``).

Serving prefill passes a mask, so in the JAX package it never reaches the
flash kernel either: it is this dense path, two products and a softmax,
left to ``torch.matmul``-class operators as the JAX package left it to XLA.
The flash kernel comes with the training slice.
"""

import math

import torch


def _scale_for(q):
    # 1 / sqrt(D) rounded through q's type, as the reference computes it
    root = torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32).to(q.dtype)
    return float(1.0 / root)


def dot_product_attention(q, k, v, mask=None, causal=True, scale=None):
    """Multi-head attention over [batch, seq, heads, head_dim] tensors.

    Scores and softmax in fp32; probabilities cast back to q's type before
    the product with v.  ``mask`` broadcasts to [B, N, Sq, Sk]."""
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
    return torch.einsum("bnqk,bknd->bqnd", probs, v)
