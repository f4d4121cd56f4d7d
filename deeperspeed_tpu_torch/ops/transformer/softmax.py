"""Fused scaled softmax: kernel B8 (forward and backward) and its plain
versions (counterpart of ``deeperspeed_tpu/ops/transformer/softmax.py``).

:func:`fused_softmax` is an ``autograd.Function``: the forward is B8's
forward, ``softmax(scale * x)`` over the last dim in fp32 with the max
subtracted, output in x's type; it saves the output p, and the backward is
B8's backward, ``dx = p * (dy - sum(p * dy)) * scale`` in fp32.  For a CUDA
tensor they launch the kernels of ``csrc/softmax.cu``, at any row width
(the JAX package runs its Pallas kernel only when the width is a multiple
of 128, plain XLA otherwise: both compute this function); for a CPU tensor
:func:`_softmax_ref` and :func:`_softmax_bwd_ref`.
"""

import torch

from ...accelerator import get_accelerator
from ..cuda_utils import check, dtype_code, library, ptr, require_cuda, stream_of


def _softmax_ref(x, scale):
    """Plain version of B8's forward."""
    s = x.to(torch.float32) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def _softmax_bwd_ref(p, dy, scale):
    """Plain version of B8's backward."""
    p32, dy32 = p.to(torch.float32), dy.to(torch.float32)
    s = (p32 * dy32).sum(dim=-1, keepdim=True)
    return (p32 * (dy32 - s) * scale).to(p.dtype)


def _rows(x):
    return x.numel() // x.shape[-1] if x.shape[-1] else 0


def _fwd_cuda(x, scale):
    """B8 forward on the card: the row in registers, a warp (or a CTA) a row."""
    require_cuda("softmax_fwd", x)
    y = torch.empty_like(x)
    err = library("softmax").dst_softmax_fwd(ptr(x), ptr(y), _rows(x), x.shape[-1],
                                             float(scale), dtype_code(x.dtype),
                                             stream_of(x))
    check(err, "softmax_fwd")
    return y


def _bwd_cuda(p, dy, scale):
    """B8 backward on the card."""
    require_cuda("softmax_bwd", p, dy, dtype=p.dtype)
    if dy.shape != p.shape:
        raise ValueError(f"softmax_bwd: dy {tuple(dy.shape)} != p {tuple(p.shape)}")
    dx = torch.empty_like(p)
    err = library("softmax").dst_softmax_bwd(ptr(p), ptr(dy), ptr(dx), _rows(p),
                                             p.shape[-1], float(scale),
                                             dtype_code(p.dtype), stream_of(p))
    check(err, "softmax_bwd")
    return dx


class _Softmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale):
        x = x.contiguous()
        if get_accelerator(x.device).use_cuda_kernels():
            y = _fwd_cuda(x, scale)
        else:
            y = _softmax_ref(x, scale)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (p,) = ctx.saved_tensors
        dy = dy.contiguous()
        if get_accelerator(p.device).use_cuda_kernels():
            return _bwd_cuda(p, dy, ctx.scale), None
        return _softmax_bwd_ref(p, dy, ctx.scale), None


def fused_softmax(x, scale=1.0):
    """Softmax over the last dim with a pre-scale, fp32 internally."""
    return _Softmax.apply(x, float(scale))
