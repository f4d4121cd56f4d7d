"""Block-sparse attention: kernel B10 (forward, dq pass, dk/dv pass) and its
plain version (counterpart of
``deeperspeed_tpu/ops/sparse_attention/sparse_attention.py``).

:func:`sparse_attention` over [B, S, N, D] q/k/v and a block layout
``[N or 1, nq, nk]`` (nonzero: the block pair attends; one head broadcasts
over all) is an ``autograd.Function``, the JAX package's ``custom_vjp``:
the forward saves (q, k, v, O, LSE); the backward takes
``delta = rowsum(dO * O)`` in plain fp32 ops and runs the dq and dk/dv
passes.  As in the JAX package the scores are ``q . k^T`` in fp32 times
``scale`` (q is not pre-scaled), P is rounded to v's type before its
products and dS to q's type.  ``block = S / nq``.

For CUDA tensors the kernels of ``csrc/sparse_attention.cu`` run: fp32 or
bf16, D <= 128, blocks that are multiples of 16; anything else raises.
bf16 runs on the tensor-core kernels, which take D of 16, 32, 64 or 128:
:func:`_operands` zero-pads D up to the next of them (the scale is passed
in, so the scores do not move) and copies a misaligned view.  With a block
that is a multiple of 64 all three bf16 passes run on the Hopper kernels
(TMA and ``wgmma``, walking only the layout's live 64-row tiles), with
blocks of 16, 32 or 48 on ``mma.sync``; the same wrappers launch both,
and a refused launch raises.  For CPU
tensors :func:`_fwd_reference` and :func:`_bwd_reference` compute the same
functions densely, the layout expanded to a token mask.

A query row whose every key is masked (a causal call over a layout whose
only live block in that row lies above the diagonal) gets zeros: O, its
dq, and its share of dk and dv.  The JAX kernel returns the mean of v over
the masked tile's keys there instead (it takes exp(NEG_INF - NEG_INF) = 1
while its running max is still NEG_INF); its docstring promises zeros,
which is what the port gives.  No shipped configuration produces such a
row under ``attention="unidirectional"``.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ...accelerator import get_accelerator
from ..attention.flash import _unpad
from ..cuda_utils import NEG_INF, check, dtype_code, library, ptr, require_cuda, \
    stream_of

MAX_HEAD_DIM = 128
_TC_HEAD_DIMS = (16, 32, 64, 128)


def _token_mask(layout, S, causal):
    """Bool [LH, S, S]: which (query, key) pairs attend."""
    block = S // layout.shape[1]
    live = layout.bool().repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        live = live & torch.ones(S, S, dtype=torch.bool, device=layout.device).tril()
    return live


def _scores(q, k, scale):
    return torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale


def _fwd_reference(q, k, v, layout, causal, scale):
    """Plain version of B10's forward: (O in q's type, LSE fp32 [B*N, S]).
    One batch row at a time, to bound the [N, S, S] intermediates."""
    B, S, N, _ = q.shape
    live = _token_mask(layout, S, causal)
    outs, lses = [], []
    for b in range(B):
        s = _scores(q[b:b + 1], k[b:b + 1], scale).masked_fill(~live, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m).masked_fill(~live, 0.0)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), v[b:b + 1].float())
        inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
        outs.append(o * inv.squeeze(-1).transpose(1, 2)[..., None])
        lses.append(torch.where(l > 0, m + torch.log(l), torch.full_like(l, NEG_INF))
                    .reshape(N, S))
    return torch.cat(outs).to(q.dtype), torch.cat(lses)


def _bwd_reference(q, k, v, do, lse, delta, layout, causal, scale):
    """Plain version of B10's dq and dk/dv passes: (dq, dk, dv) in q's type.
    ``lse`` and ``delta`` are fp32 [B*N, S]."""
    B, S, N, _ = q.shape
    dt = q.dtype
    live = _token_mask(layout, S, causal)
    grads = []
    for b in range(B):
        rows = slice(b * N, (b + 1) * N)
        s = _scores(q[b:b + 1], k[b:b + 1], scale)
        p = torch.exp(s - lse[rows].reshape(1, N, S, 1)).masked_fill(~live, 0.0)
        dp = torch.einsum("bqnd,bknd->bnqk", do[b:b + 1].float(), v[b:b + 1].float())
        ds = (p * (dp - delta[rows].reshape(1, N, S, 1)) * scale).to(dt).float()
        dv = torch.einsum("bnqk,bqnd->bknd", p.to(dt).float(), do[b:b + 1].float())
        dk = torch.einsum("bnqk,bqnd->bknd", ds, q[b:b + 1].float())
        dq = torch.einsum("bnqk,bknd->bqnd", ds, k[b:b + 1].float())
        grads.append((dq, dk, dv))
    return tuple(torch.cat(g).to(dt) for g in zip(*grads))


def _check(kernel, layout, block, *ts):
    require_cuda(kernel, *ts, dtype=ts[0].dtype)
    require_cuda(kernel, layout, dtype=torch.int32)
    B, S, N, D = shape = ts[0].shape
    if any(t.shape != shape for t in ts) or len(shape) != 4:
        raise ValueError(f"{kernel}: q, k, v (and dO) must share one [B, S, N, D] shape")
    if ts[0].dtype not in (torch.float32, torch.bfloat16) or D > MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: takes fp32/bf16 with D <= {MAX_HEAD_DIM}, "
                         f"got {ts[0].dtype} D={D}")
    if block % 16:
        raise ValueError(f"{kernel}: the card's kernels take blocks that are "
                         f"multiples of 16, got block {block}")
    if layout.dim() != 3 or layout.shape[0] not in (1, N) or \
            layout.shape[1:] != (S // block, S // block) or S % block:
        raise ValueError(f"{kernel}: layout {tuple(layout.shape)} does not fit S={S}, "
                         f"N={N}, block={block}")
    return shape


def _operands(*ts):
    """bf16 operands as the tensor-core kernels take them: D zero-padded to
    16, 32, 64 or 128 and every base 16-byte aligned (fp32 passes as is)."""
    if ts[0].dtype != torch.bfloat16:
        return ts
    D = ts[0].shape[-1]
    pad = next(d for d in _TC_HEAD_DIMS if d >= D) - D
    if pad:
        return tuple(F.pad(t, (0, pad)) for t in ts)
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def _fwd_cuda(q, k, v, layout, causal, scale, block):
    """B10 forward on the card."""
    B, S, N, D = _check("sparse_fwd", layout, block, q, k, v)
    q, k, v = _operands(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(B * N, S, dtype=torch.float32, device=q.device)
    err = library("sparse_attention").dst_sparse_fwd(
        ptr(q), ptr(k), ptr(v), ptr(layout), ptr(o), ptr(lse), B, S, N, q.shape[-1],
        layout.shape[0], block, int(causal), float(scale), dtype_code(q.dtype),
        stream_of(q))
    check(err, "sparse_fwd")
    return _unpad(o, D), lse


def _dq_cuda(q, k, v, do, lse, delta, layout, causal, scale, block):
    """B10 dq pass on the card."""
    B, S, N, D = _check("sparse_bwd_dq", layout, block, q, k, v, do)
    require_cuda("sparse_bwd_dq", lse, delta, dtype=torch.float32)
    q, k, v, do = _operands(q, k, v, do)
    dq = torch.empty_like(q)
    err = library("sparse_attention").dst_sparse_bwd_dq(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(layout), ptr(dq),
        B, S, N, q.shape[-1], layout.shape[0], block, int(causal), float(scale),
        dtype_code(q.dtype), stream_of(q))
    check(err, "sparse_bwd_dq")
    return _unpad(dq, D)


def _dkv_cuda(q, k, v, do, lse, delta, layout, causal, scale, block):
    """B10 dk/dv pass on the card."""
    B, S, N, D = _check("sparse_bwd_dkv", layout, block, q, k, v, do)
    require_cuda("sparse_bwd_dkv", lse, delta, dtype=torch.float32)
    q, k, v, do = _operands(q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = library("sparse_attention").dst_sparse_bwd_dkv(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(layout), ptr(dk),
        ptr(dv), B, S, N, q.shape[-1], layout.shape[0], block, int(causal), float(scale),
        dtype_code(q.dtype), stream_of(q))
    check(err, "sparse_bwd_dkv")
    return _unpad(dk, D), _unpad(dv, D)


class _SparseAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, layout, causal, scale, block):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if get_accelerator(q.device).use_cuda_kernels():
            o, lse = _fwd_cuda(q, k, v, layout, causal, scale, block)
        else:
            o, lse = _fwd_reference(q, k, v, layout, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, layout)
        ctx.args = (causal, scale, block)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, layout = ctx.saved_tensors
        causal, scale, block = ctx.args
        do = do.contiguous()
        B, S, N, _ = q.shape
        # delta = rowsum(dO * O) in fp32, [B, S, N] -> [B*N, S] like the LSE
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * N, S)
        delta = delta.contiguous()
        if get_accelerator(q.device).use_cuda_kernels():
            dq = _dq_cuda(q, k, v, do, lse, delta, layout, causal, scale, block)
            dk, dv = _dkv_cuda(q, k, v, do, lse, delta, layout, causal, scale, block)
        else:
            dq, dk, dv = _bwd_reference(q, k, v, do, lse, delta, layout, causal, scale)
        return dq, dk, dv, None, None, None, None


def device_layout(layout, device):
    """``layout`` ([N or 1, nq, nk] or [nq, nk], numpy or torch) as a
    contiguous int32 [LH, nq, nk] tensor on ``device``."""
    layout = torch.as_tensor(np.asarray(layout) if not torch.is_tensor(layout) else layout)
    if layout.dim() == 2:
        layout = layout[None]
    return layout.to(device=device, dtype=torch.int32).contiguous()


def sparse_attention(q, k, v, layout, causal=True, scale=None, block=None):
    """Block-sparse attention: [B, S, N, D] q/k/v and a layout
    ``[N or 1, nq, nk]`` -> [B, S, N, D].  Differentiable."""
    B, S, N, D = q.shape
    layout = device_layout(layout, q.device)
    nq = layout.shape[1]
    if block is None:
        if S % nq:
            raise ValueError(f"S={S} not divisible by layout blocks {nq}")
        block = S // nq
    if S % block or layout.shape[1:] != (S // block, S // block) \
            or layout.shape[0] not in (1, N):
        raise ValueError(f"layout {tuple(layout.shape)} does not fit S={S}, N={N}, "
                         f"block={block}")
    if scale is None:
        scale = float(D) ** -0.5
    return _SparseAttention.apply(q, k, v, layout, bool(causal), float(scale), int(block))


class SparseSelfAttention:
    """Reference ``SparseSelfAttention`` surface: bind a sparsity config and
    apply it to [B, S, N, D] q/k/v.  Layouts are made once per sequence
    length (``_layouts``) and put on a device once per (length, device)."""

    def __init__(self, sparsity_config, causal=True, scale=None):
        self.sparsity_config = sparsity_config
        self.causal = causal
        self.scale = scale
        self._layouts = {}
        self._on_device = {}

    def layout(self, seq_len):
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def device_layout(self, seq_len, device):
        key = (seq_len, torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = device_layout(self.layout(seq_len), device)
        return self._on_device[key]

    def __call__(self, q, k, v):
        S = q.shape[1]
        return sparse_attention(q, k, v, self.device_layout(S, q.device), causal=self.causal,
                                scale=self.scale, block=self.sparsity_config.block)
