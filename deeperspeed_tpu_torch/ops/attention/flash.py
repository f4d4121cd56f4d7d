"""Flash attention: kernels K5 (forward), K7 (dq) and K6 (dk/dv) and their
plain versions (counterpart of ``deeperspeed_tpu/ops/attention/flash.py``
and ``pallas_flash.py``).

:func:`mha` over [B, S, N, D] q/k/v is an ``autograd.Function``, the TPU
package's ``custom_vjp``: the forward pre-scales q by the softmax scale in
q's type and saves (pre-scaled q, k, v, O, LSE); the backward computes
``delta = rowsum(dO * O)`` in plain fp32 ops, runs the two backward
kernels on the pre-scaled q, and post-scales dq in q's type, exactly where
``_mha_fwd`` / ``_mha_bwd`` round.  The LSE is fp32 [B*N, S].

For CUDA tensors the kernels of ``csrc/flash_attention.cu`` run (fp32 or
bf16, D a multiple of 8 up to 128, any S, causal or not); for CPU tensors
:func:`_fwd_reference` and :func:`_bwd_reference` compute the same
functions in PyTorch, the backward recomputing P from the LSE.  bf16 runs
on the tensor-core kernels only, which take D a multiple of 16 and 16-byte
aligned rows: :func:`_tc_operands` zero-pads D = 8 mod 16 up to the next
multiple of 16 (q is pre-scaled, so the scores, P and the first D columns
of every output are unchanged) and copies a misaligned view.
"""

import torch
import torch.nn.functional as F

from ...accelerator import get_accelerator
from ..cuda_utils import NEG_INF, check, dtype_code, library, ptr, \
    require_cuda, stream_of

MAX_HEAD_DIM = 128


def flash_attention_supported(q_shape, dtype=None):
    """True when the flash path takes this [B, S, N, D] shape and dtype,
    forward and backward: the JAX package's rule, fp32/bf16 and D % 8 == 0.
    The card's kernels also need D <= 128 and raise above it."""
    if dtype is not None and dtype not in (torch.float32, torch.bfloat16):
        return False
    return q_shape[-1] % 8 == 0


def _live(S, causal, device):
    """[S, S] bool: which (query, key) pairs attend."""
    if not causal:
        return torch.ones(S, S, dtype=torch.bool, device=device)
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()


def _scores(qp, k, causal):
    """fp32 [B, N, S, S] scores of pre-scaled q, masked with NEG_INF."""
    s = torch.einsum("bqnd,bknd->bnqk", qp.float(), k.float())
    return s.masked_fill(~_live(s.shape[-1], causal, s.device), NEG_INF)


def _fwd_reference(qp, k, v, causal):
    """Plain version of K5: (O in q's type, LSE fp32 [B*N, S])."""
    B, S, N, _ = qp.shape
    s = _scores(qp, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    # P rounded to v's type before the product, as in the kernel
    o = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), v.float())
    o = o / l.squeeze(-1).transpose(1, 2)[..., None]
    lse = (m + torch.log(l)).reshape(B * N, S)
    return o.to(qp.dtype), lse


def _bwd_reference(qp, k, v, do, lse, delta, causal):
    """Plain version of K7 + K6: (dq, dk, dv) in q's type, grads of the
    pre-scaled q.  ``lse`` and ``delta`` are fp32 [B*N, S]."""
    B, S, N, _ = qp.shape
    s = _scores(qp, k, causal)
    live = _live(S, causal, s.device)
    p = torch.exp(s - lse.reshape(B, N, S, 1)).masked_fill(~live, 0.0)
    dp = torch.einsum("bqnd,bknd->bnqk", do.float(), v.float())
    ds = p * (dp - delta.reshape(B, N, S, 1))
    dt = qp.dtype
    dv = torch.einsum("bnqk,bqnd->bknd", p.to(dt).float(), do.float())
    dk = torch.einsum("bnqk,bqnd->bknd", ds.to(dt).float(), qp.float())
    dq = torch.einsum("bnqk,bknd->bqnd", ds.to(dt).float(), k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check(kernel, *ts):
    require_cuda(kernel, *ts, dtype=ts[0].dtype)
    shape = ts[0].shape
    if any(t.shape != shape for t in ts) or len(shape) != 4:
        raise ValueError(f"{kernel}: q, k, v (and dO) must share one "
                         f"[B, S, N, D] shape")
    if not flash_attention_supported(shape, ts[0].dtype) or shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: takes fp32/bf16 with D % 8 == 0 and "
                         f"D <= {MAX_HEAD_DIM}, got {ts[0].dtype} D={shape[-1]}")
    return shape


def _tc_operands(*ts):
    """bf16 operands as the tensor-core kernels take them: D zero-padded to
    a multiple of 16 and every base 16-byte aligned (fp32 passes as is)."""
    if ts[0].dtype != torch.bfloat16:
        return ts
    pad = -ts[0].shape[-1] % 16
    if pad:
        return tuple(F.pad(t, (0, pad)) for t in ts)
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def _unpad(t, D):
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def _fwd_cuda(qp, k, v, causal):
    """K5 on the card."""
    B, S, N, D = _check("flash_fwd", qp, k, v)
    qp, k, v = _tc_operands(qp, k, v)
    o = torch.empty_like(qp)
    lse = torch.empty(B * N, S, dtype=torch.float32, device=qp.device)
    err = library("flash_attention").dst_flash_fwd(
        ptr(qp), ptr(k), ptr(v), ptr(o), ptr(lse), B, S, N, qp.shape[-1],
        int(causal), dtype_code(qp.dtype), stream_of(qp))
    check(err, "flash_fwd")
    return _unpad(o, D), lse


def _dq_cuda(qp, k, v, do, lse, delta, causal):
    """K7 on the card: dq of the pre-scaled q."""
    B, S, N, D = _check("flash_bwd_dq", qp, k, v, do)
    require_cuda("flash_bwd_dq", lse, delta, dtype=torch.float32)
    qp, k, v, do = _tc_operands(qp, k, v, do)
    dq = torch.empty_like(qp)
    err = library("flash_attention").dst_flash_bwd_dq(
        ptr(qp), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq),
        B, S, N, qp.shape[-1], int(causal), dtype_code(qp.dtype), stream_of(qp))
    check(err, "flash_bwd_dq")
    return _unpad(dq, D)


def _dkv_cuda(qp, k, v, do, lse, delta, causal):
    """K6 on the card: dk and dv."""
    B, S, N, D = _check("flash_bwd_dkv", qp, k, v, do)
    require_cuda("flash_bwd_dkv", lse, delta, dtype=torch.float32)
    qp, k, v, do = _tc_operands(qp, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = library("flash_attention").dst_flash_bwd_dkv(
        ptr(qp), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dk),
        ptr(dv), B, S, N, qp.shape[-1], int(causal), dtype_code(qp.dtype),
        stream_of(qp))
    check(err, "flash_bwd_dkv")
    return _unpad(dk, D), _unpad(dv, D)


def _fwd(qp, k, v, causal):
    if get_accelerator(qp.device).use_cuda_kernels():
        return _fwd_cuda(qp, k, v, causal)
    return _fwd_reference(qp, k, v, causal)


def _bwd(qp, k, v, do, lse, delta, causal):
    if get_accelerator(qp.device).use_cuda_kernels():
        dq = _dq_cuda(qp, k, v, do, lse, delta, causal)
        return (dq, *_dkv_cuda(qp, k, v, do, lse, delta, causal))
    return _bwd_reference(qp, k, v, do, lse, delta, causal)


def _scaled(x, scale):
    """``x * scale`` with the scale rounded to x's type first (jnp.asarray
    (scale, x.dtype) in the JAX package)."""
    return x * torch.tensor(scale, dtype=x.dtype, device=x.device)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        qp = _scaled(q.contiguous(), scale)
        k, v = k.contiguous(), v.contiguous()
        o, lse = _fwd(qp, k, v, causal)
        ctx.save_for_backward(qp, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qp, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        B, S, N, _ = qp.shape
        # delta = rowsum(dO * O) in fp32, left to plain ops as the JAX
        # package left it to XLA; [B, S, N] -> [B*N, S] like the LSE
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S)
        dq, dk, dv = _bwd(qp, k, v, do, lse, delta.contiguous(), ctx.causal)
        return _scaled(dq, ctx.scale), dk, dv, None, None


def mha(q, k, v, causal=True, scale=None):
    """Blocked multi-head attention: [B, S, N, D] q/k/v -> [B, S, N, D].

    Any S; D a multiple of 8 (up to 128 on the card).  Differentiable."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))


def flash_attention(q, k, v, causal=True, scale=None):
    """[B, S, N, D] q/k/v -> [B, S, N, D]; bf16/fp32 in, same dtype out."""
    return mha(q, k, v, causal=causal, scale=scale)
