"""Paged-KV decode attention: kernels K2 and K3 and their plain versions
(counterpart of ``deeperspeed_tpu/ops/attention/paged.py``).

The KV pools are [P, bs, N, D] per layer and a sequence's tokens live in
the pool blocks its row of ``block_tables`` names.  For CUDA tensors,
:func:`paged_decode_attention` (one query per sequence) and
:func:`paged_spec_decode_attention` (S <= 8 queries per sequence) launch the
hand-written kernel of ``csrc/paged_attention.cu``, which walks only each
sequence's live tokens.  For CPU tensors they run the plain versions
(:func:`_decode_reference`, :func:`_spec_decode_reference`): gather the
table's blocks densely and mask.

Not ported yet: the int8/fp8 pools with per-(slot, head) scales, and the
long-context partial-attention helpers.
"""

import torch

from ...accelerator import get_accelerator
from ..cuda_utils import NEG_INF, check, dtype_code, library, ptr, \
    require_cuda, stream_of

MAX_QUERIES = 8
MAX_HEAD_DIM = 128


def _gather(pool, block_tables):
    B = block_tables.shape[0]
    _, _, N, D = pool.shape
    return pool[block_tables.long()].reshape(B, -1, N, D).to(torch.float32)


def _decode_reference(q, pool_k, pool_v, block_tables, seq_lens, scale):
    """Plain version of K2."""
    K, V = _gather(pool_k, block_tables), _gather(pool_v, block_tables)
    s = torch.einsum("bnd,btnd->btn", q.to(torch.float32), K) * scale
    t = torch.arange(K.shape[1], device=q.device)
    s = torch.where((t[None, :] < seq_lens[:, None])[..., None], s, NEG_INF)
    p = torch.softmax(s, dim=1)
    return torch.einsum("btn,btnd->bnd", p, V).to(q.dtype)


def _spec_decode_reference(q, pool_k, pool_v, block_tables, positions, scale):
    """Plain version of K3: query sq of row b sees tokens t <= positions[b, sq]."""
    K, V = _gather(pool_k, block_tables), _gather(pool_v, block_tables)
    s = torch.einsum("bsnd,btnd->bstn", q.to(torch.float32), K) * scale
    t = torch.arange(K.shape[1], device=q.device)
    mask = t[None, None, :] <= positions[:, :, None]           # [B, S, T]
    s = torch.where(mask[..., None], s, NEG_INF)
    p = torch.softmax(s, dim=2)
    return torch.einsum("bstn,btnd->bsnd", p, V).to(q.dtype)


def _check_pools(kernel, q, pool_k, pool_v, block_tables, lens):
    require_cuda(kernel, q, pool_k, pool_v, dtype=q.dtype)
    require_cuda(kernel, q, block_tables, lens)
    _, _, N, D = pool_k.shape
    if pool_v.shape != pool_k.shape or q.shape[-2:] != (N, D):
        raise ValueError(f"{kernel}: q {tuple(q.shape)} does not match pools "
                         f"{tuple(pool_k.shape)} / {tuple(pool_v.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: head_dim {D} > {MAX_HEAD_DIM}")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"{kernel}: block tables and lengths must be int32")


def _decode_cuda(q, pool_k, pool_v, block_tables, seq_lens, scale):
    """K2 on the card."""
    _check_pools("paged_decode", q, pool_k, pool_v, block_tables, seq_lens)
    B, N, D = q.shape
    _, bs, _, _ = pool_k.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = library("paged_attention").dst_paged_decode(
        ptr(q), ptr(pool_k), ptr(pool_v), ptr(block_tables), ptr(seq_lens),
        ptr(out), B, N, D, bs, block_tables.shape[1], float(scale),
        dtype_code(q.dtype), stream_of(q))
    check(err, "paged_decode")
    return out


def _spec_decode_cuda(q, pool_k, pool_v, block_tables, positions, scale):
    """K3 on the card."""
    _check_pools("paged_spec_decode", q, pool_k, pool_v, block_tables,
                 positions)
    B, S, N, D = q.shape
    if S > MAX_QUERIES:
        raise ValueError(f"paged_spec_decode: {S} queries > {MAX_QUERIES}")
    _, bs, _, _ = pool_k.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = library("paged_attention").dst_paged_spec_decode(
        ptr(q), ptr(pool_k), ptr(pool_v), ptr(block_tables), ptr(positions),
        ptr(out), B, S, N, D, bs, block_tables.shape[1], float(scale),
        dtype_code(q.dtype), stream_of(q))
    check(err, "paged_spec_decode")
    return out


def _no_scales(k_scale, v_scale):
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8/fp8 KV pools (k_scale/v_scale) are not ported yet")


def paged_spec_decode_attention(q, pool_k, pool_v, block_tables, positions,
                                scale=None, k_scale=None, v_scale=None):
    """Speculative decode: S = k+1 query tokens per row over a blocked pool.

    q            [B, S, N, D]  queries (last committed token + k drafts)
    positions    [B, S] int32  ascending absolute position of each query;
                               query sq attends pool tokens t <= positions[b, sq]
    -> [B, S, N, D] in q's type
    """
    _no_scales(k_scale, v_scale)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if get_accelerator(q.device).use_cuda_kernels():
        return _spec_decode_cuda(q, pool_k, pool_v, block_tables, positions,
                                 scale)
    return _spec_decode_reference(q, pool_k, pool_v, block_tables, positions,
                                  scale)


def paged_decode_attention(q, pool_k, pool_v, block_tables, seq_lens,
                           scale=None, k_scale=None, v_scale=None):
    """One decode step over a blocked KV pool.

    q            [B, N, D]     current-token queries
    pool_k/v     [P, bs, N, D] shared cache pools
    block_tables [B, max_blocks] int32 pool-block ids per sequence
    seq_lens     [B] int32     live tokens per sequence (incl. current)
    -> [B, N, D] in q's type
    """
    _no_scales(k_scale, v_scale)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if get_accelerator(q.device).use_cuda_kernels():
        return _decode_cuda(q, pool_k, pool_v, block_tables, seq_lens, scale)
    return _decode_reference(q, pool_k, pool_v, block_tables, seq_lens, scale)
