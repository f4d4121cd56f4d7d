"""tanh-GELU: kernel B9 (forward and backward) and its plain versions
(counterpart of ``deeperspeed_tpu/ops/transformer/activations.py``).

:func:`gelu_tanh` is an ``autograd.Function`` whose forward is B9's forward
and whose backward is B9's backward on the saved input x (the JAX package's
``custom_vjp`` saves x, not y).  For a CUDA tensor they launch the kernels
of ``csrc/activations.cu``; for a CPU tensor :func:`_gelu_ref` and
:func:`_dgelu_ref`, the same arithmetic in PyTorch: fp32 inside, in the
reference's order of operations, one rounding to the input's type.
:func:`bias_gelu` is ``gelu_tanh(x + bias)``, as in the JAX package.
"""

import torch

from ...accelerator import get_accelerator
from ..cuda_utils import check, dtype_code, library, ptr, require_cuda, stream_of

_C0 = 0.7978845608028654  # sqrt(2/pi)
_C1 = 0.044715


def _gelu_ref(x):
    """Plain version of B9's forward."""
    x32 = x.to(torch.float32)
    inner = _C0 * (x32 + _C1 * x32 * x32 * x32)
    return (0.5 * x32 * (1.0 + torch.tanh(inner))).to(x.dtype)


def _dgelu_ref(x, dy):
    """Plain version of B9's backward: gelu'(x) * dy."""
    x32 = x.to(torch.float32)
    inner = _C0 * (x32 + _C1 * x32 * x32 * x32)
    t = torch.tanh(inner)
    dinner = _C0 * (1.0 + (3.0 * _C1) * x32 * x32)
    d = 0.5 * (1.0 + t) + 0.5 * x32 * (1.0 - t * t) * dinner
    return (d * dy.to(torch.float32)).to(x.dtype)


def _gelu_cuda(x):
    """B9 forward on the card: one launch over the flat tensor."""
    require_cuda("gelu_fwd", x)
    y = torch.empty_like(x)
    err = library("activations").dst_gelu_fwd(ptr(x), ptr(y), x.numel(),
                                               dtype_code(x.dtype), stream_of(x))
    check(err, "gelu_fwd")
    return y


def _dgelu_cuda(x, dy):
    """B9 backward on the card."""
    require_cuda("gelu_bwd", x, dy, dtype=x.dtype)
    if dy.shape != x.shape:
        raise ValueError(f"gelu_bwd: dy {tuple(dy.shape)} != x {tuple(x.shape)}")
    dx = torch.empty_like(x)
    err = library("activations").dst_gelu_bwd(ptr(x), ptr(dy), ptr(dx), x.numel(),
                                               dtype_code(x.dtype), stream_of(x))
    check(err, "gelu_bwd")
    return dx


class _Gelu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        ctx.save_for_backward(x)
        if get_accelerator(x.device).use_cuda_kernels():
            return _gelu_cuda(x)
        return _gelu_ref(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        dy = dy.contiguous()
        if get_accelerator(x.device).use_cuda_kernels():
            return _dgelu_cuda(x, dy)
        return _dgelu_ref(x, dy)


def gelu_tanh(x):
    """Tanh-approximated GELU (the NeoX/reference variant); differentiable."""
    return _Gelu.apply(x)


def bias_gelu(x, bias):
    """Bias add, then GELU (reference ``fused_bias_gelu``)."""
    return gelu_tanh(x + bias)
