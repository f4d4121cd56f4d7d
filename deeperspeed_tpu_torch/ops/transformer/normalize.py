"""LayerNorm / RMSNorm forward: kernel K1 and its plain version
(counterpart of ``deeperspeed_tpu/ops/transformer/normalize.py``).

For a CUDA tensor, :func:`layer_norm` and :func:`rms_norm` launch the
hand-written kernel of ``csrc/layer_norm.cu`` (any hidden size); for a CPU
tensor they run :func:`_ln_ref`, the same arithmetic in PyTorch: fp32
statistics, the centred variance, output in the input's type.  The
backward kernel belongs to the training slice.
"""

import torch

from ...accelerator import get_accelerator
from ..cuda_utils import check, dtype_code, library, ptr, require_cuda, \
    stream_of


def _ln_ref(x, gamma, beta, eps, rms):
    """Plain version of K1."""
    x32 = x.to(torch.float32)
    mu = 0.0 if rms else x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * gamma.to(torch.float32)
    if beta is not None:
        y = y + beta.to(torch.float32)
    return y.to(x.dtype)


def _ln_cuda(x, gamma, beta, eps, rms):
    """K1 on the card: one launch over all rows of ``x``."""
    h = x.shape[-1]
    vecs = (gamma,) if beta is None else (gamma, beta)
    require_cuda("layer_norm", x, *vecs)
    for v in vecs:
        if v.dtype != torch.float32 or v.shape != (h,):
            raise ValueError(f"layer_norm: gamma/beta must be float32 [{h}]")
    y = torch.empty_like(x)
    rows = x.numel() // h
    if rows == 0:
        return y
    err = library("layer_norm").dst_layer_norm_fwd(
        ptr(x), ptr(gamma), None if beta is None else ptr(beta), ptr(y),
        rows, h, float(eps), int(rms), dtype_code(x.dtype), stream_of(x))
    check(err, "layer_norm")
    return y


def _norm(x, gamma, beta, eps, rms):
    if get_accelerator(x.device).use_cuda_kernels():
        return _ln_cuda(x, gamma, beta, eps, rms)
    return _ln_ref(x, gamma, beta, eps, rms)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last dim; fp32 statistics."""
    return _norm(x, gamma, beta, eps, False)


def rms_norm(x, gamma, eps=1e-5):
    """RMSNorm over the last dim."""
    return _norm(x, gamma, None, eps, True)
