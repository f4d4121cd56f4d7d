"""LayerNorm / RMSNorm: kernels K1 (forward) and K8 (backward) and their
plain versions (counterpart of ``deeperspeed_tpu/ops/transformer/normalize.py``).

:func:`layer_norm` and :func:`rms_norm` are differentiable: an
``autograd.Function`` whose forward is K1 and whose backward is K8 (the
TPU package's ``custom_vjp``).  For a CUDA tensor they launch the
hand-written kernels of ``csrc/layer_norm.cu`` (any hidden size); for a CPU
tensor they run :func:`_ln_ref` and :func:`_ln_bwd_ref`, the same
arithmetic in PyTorch: fp32 statistics, the centred variance, output in the
input's type, the backward recomputing the statistics from x.

The forward is on the serving path once or twice a layer every decode
round, where the host's time per call sets the round, so its call path is
short: where nothing needs a gradient (grad mode off, as under
``torch.no_grad`` or ``inference_mode``, or no input requiring one) it
calls the forward directly, without the ``autograd.Function``; the tensor's
own device picks the kernel or the plain version; and the checks are a few
attribute reads.

gamma and beta may come in any float type (bf16 under mixed-precision
training, where the engine casts every weight but the input embedding):
K1 takes them in their own type and upcasts them in registers, which is
exact, so the forward casts nothing.  K8 takes gamma the same way, so the
backward casts nothing before it either; dgamma/dbeta come back from it in
fp32 and are cast to gamma's type, as in the JAX package's ``_norm_bwd``.
"""

import functools

import torch

from ..cuda_utils import check, dtype_code, library, ptr, require_cuda, \
    stream_of

# K8's CTAs an SM at most: each CTA takes one strip of rows and writes one
# fp32 partial row of dgamma and of dbeta
BWD_CTAS_PER_SM = 4


def _ln_ref(x, gamma, beta, eps, rms):
    """Plain version of K1."""
    x32 = x.to(torch.float32)
    mu = 0.0 if rms else x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * gamma.to(torch.float32)
    if beta is not None:
        y = y + beta.to(torch.float32)
    return y.to(x.dtype)


def _ln_bwd_ref(x, gamma, dy, eps, rms):
    """Plain version of K8 over [rows, H]: (dx, dgamma, dbeta) with the
    parameter grads in fp32 (``_norm_bwd``'s jnp branch)."""
    x32, dy32 = x.to(torch.float32), dy.to(torch.float32)
    mu = 0.0 if rms else x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mu) * rstd
    dyg = dy32 * gamma.to(torch.float32)
    m2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    if rms:
        dx = (dyg - xhat * m2) * rstd
    else:
        dx = (dyg - dyg.mean(dim=-1, keepdim=True) - xhat * m2) * rstd
    return dx.to(x.dtype), (dy32 * xhat).sum(dim=0), dy32.sum(dim=0)


_GAMMA_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ln_cuda(x, gamma, beta, eps, rms):
    """K1 on the card: one launch over all rows of ``x``.  x contiguous in
    fp32, bf16 or fp16; gamma and beta [H], contiguous, on x's card, both
    of one float type (any of the three)."""
    h = x.shape[-1]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"layer_norm: tensors on {dev}, not on a CUDA device")
    if not x.is_contiguous():
        raise ValueError("layer_norm: tensors must be contiguous")
    code, gcode = dtype_code(x.dtype), dtype_code(gamma.dtype)
    for v in (gamma,) if beta is None else (gamma, beta):
        if v.device != dev or not v.is_contiguous() or v.shape != (h,) \
                or v.dtype != gamma.dtype:
            raise ValueError(f"layer_norm: gamma/beta must be contiguous [{h}] "
                             f"of one dtype on {dev}")
    y = torch.empty_like(x)
    rows = x.numel() // h
    if rows == 0:
        return y
    err = library("layer_norm").dst_layer_norm_fwd(
        ptr(x), ptr(gamma), None if beta is None else ptr(beta), ptr(y),
        rows, h, eps, rms, code, gcode, stream_of(x))
    check(err, "layer_norm")
    return y


def _ln_bwd_cuda(x, gamma, dy, eps, rms):
    """K8 on the card over [rows, H]: the row kernel and the fixed-order
    sum of its per-CTA partials, counted as one launch.  x and dy
    contiguous, of one type; gamma [H], contiguous, on x's card, of any
    float type.  dgamma and dbeta come back in fp32."""
    rows, h = x.shape
    require_cuda("layer_norm_bwd", x, dy, dtype=x.dtype)
    require_cuda("layer_norm_bwd", x, gamma)
    if gamma.dtype not in _GAMMA_DTYPES or gamma.shape != (h,):
        raise ValueError(f"layer_norm_bwd: gamma must be [{h}] of a float type")
    dx = torch.empty_like(x)
    if rows == 0:
        return (dx, torch.zeros(h, dtype=torch.float32, device=x.device),
                torch.zeros(h, dtype=torch.float32, device=x.device))
    # every entry of dg and db is written by the kernel's second pass
    dg = torch.empty(h, dtype=torch.float32, device=x.device)
    db = torch.empty(h, dtype=torch.float32, device=x.device)
    cap = min(rows, BWD_CTAS_PER_SM * _sm_count(x.device.index))
    parts = torch.empty(2 * cap * h, dtype=torch.float32, device=x.device)
    err = library("layer_norm").dst_layer_norm_bwd(
        ptr(x), ptr(gamma), ptr(dy), ptr(dx), ptr(parts), ptr(dg), ptr(db),
        rows, h, float(eps), int(rms), cap, dtype_code(x.dtype),
        dtype_code(gamma.dtype), stream_of(x))
    check(err, "layer_norm_bwd")
    return dx, dg, db


def _fwd(x, gamma, beta, eps, rms):
    # the entry points resolved the device: a CUDA tensor launches K1 (or
    # raises), a CPU tensor takes the plain version
    if x.is_cuda:
        return _ln_cuda(x, gamma, beta, eps, rms)
    return _ln_ref(x, gamma, beta, eps, rms)


def _bwd(x, gamma, dy, eps, rms):
    if x.is_cuda:
        return _ln_bwd_cuda(x, gamma, dy, eps, rms)
    return _ln_bwd_ref(x, gamma, dy, eps, rms)


class _Norm(torch.autograd.Function):
    """K1 forward, K8 backward; saves x and gamma, as the JAX VJP does."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, rms):
        x = x.contiguous()
        ctx.save_for_backward(x, gamma)
        ctx.eps, ctx.rms = eps, rms
        ctx.gamma_dtype = gamma.dtype
        ctx.has_beta = beta is not None
        return _fwd(x, gamma, beta, eps, rms)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        h = x.shape[-1]
        dx, dg, db = _bwd(x.reshape(-1, h), gamma,
                          dy.contiguous().reshape(-1, h), ctx.eps, ctx.rms)
        dg = dg.to(ctx.gamma_dtype)
        db = db.to(ctx.gamma_dtype) if ctx.has_beta else None
        return dx.reshape(x.shape), dg, db, None, None


def _norm(x, gamma, beta, eps, rms):
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad or (
            beta is not None and beta.requires_grad)):
        return _Norm.apply(x, gamma, beta, float(eps), bool(rms))
    return _fwd(x.contiguous(), gamma, beta, float(eps), bool(rms))


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last dim; fp32 statistics."""
    return _norm(x, gamma, beta, eps, False)


def rms_norm(x, gamma, eps=1e-5):
    """RMSNorm over the last dim."""
    return _norm(x, gamma, None, eps, True)
