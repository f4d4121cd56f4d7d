"""Paged-KV decode attention: kernels K2, K3 and their quantized forms K2q,
K3q, with their plain versions (counterpart of
``deeperspeed_tpu/ops/attention/paged.py``).

The KV pools are [P, bs, N, D] per layer and a sequence's tokens live in
the pool blocks its row of ``block_tables`` names.  A pool is either in the
query's floating-point type, or quantized (``kv_cache.dtype`` "int8" or
"fp8"): 1-byte payload beside per-(slot, head) fp32 scales ``k_scale`` /
``v_scale`` [P, bs, N].  For CUDA tensors,
:func:`paged_decode_attention` (one query per sequence) and
:func:`paged_spec_decode_attention` (S <= 8 queries per sequence) launch the
hand-written kernel of ``csrc/paged_attention.cu``, which walks only each
sequence's live tokens and, for a quantized pool, multiplies each element
by its token's scale inside that walk: no dequantized copy of the cache is
ever made.  For CPU tensors they run the plain versions
(:func:`_decode_reference`, :func:`_spec_decode_reference`): gather the
table's blocks densely, dequantize, and mask.

The kernel takes int8 and fp8 e4m3 pools; fp8 e5m2 pools are refused on the
card.  Not ported yet: the long-context partial-attention helpers.
"""

import torch

from ...accelerator import get_accelerator
from ..cuda_utils import NEG_INF, check, dtype_code, library, ptr, \
    require_cuda, stream_of
from ..quantizer import byte_view

MAX_QUERIES = 8
MAX_HEAD_DIM = 128

# pool element codes of csrc/paged_attention.cu (0: the query's own type)
_POOL_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}


def _gather(pool, block_tables, scale=None):
    """The table's blocks of ``pool`` as fp32 [B, T, N, D], dequantized by
    ``scale`` [P, bs, N] when given."""
    B = block_tables.shape[0]
    _, _, N, D = pool.shape
    idx = block_tables.long()
    out = byte_view(pool)[idx].view(pool.dtype).reshape(B, -1, N, D).to(
        torch.float32)
    if scale is not None:
        out = out * scale[idx].reshape(B, -1, N)[..., None]
    return out


def _decode_reference(q, pool_k, pool_v, block_tables, seq_lens, scale,
                      k_scale=None, v_scale=None):
    """Plain version of K2 and K2q."""
    K = _gather(pool_k, block_tables, k_scale)
    V = _gather(pool_v, block_tables, v_scale)
    s = torch.einsum("bnd,btnd->btn", q.to(torch.float32), K) * scale
    t = torch.arange(K.shape[1], device=q.device)
    s = torch.where((t[None, :] < seq_lens[:, None])[..., None], s, NEG_INF)
    p = torch.softmax(s, dim=1)
    return torch.einsum("btn,btnd->bnd", p, V).to(q.dtype)


def _spec_decode_reference(q, pool_k, pool_v, block_tables, positions, scale,
                           k_scale=None, v_scale=None):
    """Plain version of K3 and K3q: query sq of row b sees tokens
    t <= positions[b, sq]."""
    K = _gather(pool_k, block_tables, k_scale)
    V = _gather(pool_v, block_tables, v_scale)
    s = torch.einsum("bsnd,btnd->bstn", q.to(torch.float32), K) * scale
    t = torch.arange(K.shape[1], device=q.device)
    mask = t[None, None, :] <= positions[:, :, None]           # [B, S, T]
    s = torch.where(mask[..., None], s, NEG_INF)
    p = torch.softmax(s, dim=2)
    return torch.einsum("bstn,btnd->bsnd", p, V).to(q.dtype)


def _check_pools(kernel, q, pool_k, pool_v, block_tables, lens, k_scale,
                 v_scale):
    """Validate a launch; returns the kernel's pool element code."""
    quantized = k_scale is not None
    require_cuda(kernel, q, block_tables, lens, pool_k, pool_v)
    require_cuda(kernel, pool_k, pool_v,
                 dtype=pool_k.dtype if quantized else q.dtype)
    P, bs, N, D = pool_k.shape
    if pool_v.shape != pool_k.shape or q.shape[-2:] != (N, D):
        raise ValueError(f"{kernel}: q {tuple(q.shape)} does not match pools "
                         f"{tuple(pool_k.shape)} / {tuple(pool_v.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: head_dim {D} > {MAX_HEAD_DIM}")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"{kernel}: block tables and lengths must be int32")
    if not quantized:
        return 0
    if pool_k.dtype not in _POOL_CODES:
        raise TypeError(f"{kernel}: quantized pools are int8 or float8_e4m3fn,"
                        f" not {pool_k.dtype}")
    require_cuda(kernel, q, k_scale, v_scale)
    require_cuda(kernel, k_scale, v_scale, dtype=torch.float32)
    if k_scale.shape != (P, bs, N) or v_scale.shape != (P, bs, N):
        raise ValueError(f"{kernel}: scales {tuple(k_scale.shape)} / "
                         f"{tuple(v_scale.shape)} do not match pools "
                         f"{tuple(pool_k.shape)}")
    return _POOL_CODES[pool_k.dtype]


def _scale_ptr(scale):
    return None if scale is None else ptr(scale)


def _decode_cuda(q, pool_k, pool_v, block_tables, seq_lens, scale,
                 k_scale=None, v_scale=None):
    """K2 (fp pools) or K2q (quantized pools) on the card."""
    pool = _check_pools("paged_decode", q, pool_k, pool_v, block_tables, seq_lens,
                        k_scale, v_scale)
    B, N, D = q.shape
    _, bs, _, _ = pool_k.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = library("paged_attention").dst_paged_decode(
        ptr(q), ptr(pool_k), ptr(pool_v), _scale_ptr(k_scale),
        _scale_ptr(v_scale), ptr(block_tables), ptr(seq_lens), ptr(out),
        B, N, D, bs, block_tables.shape[1], float(scale),
        dtype_code(q.dtype), pool, stream_of(q))
    # one launch counter per row of the kernel table
    if k_scale is None:
        check(err, "paged_decode")
    else:
        check(err, "paged_decode_q")
    return out


def _spec_decode_cuda(q, pool_k, pool_v, block_tables, positions, scale,
                      k_scale=None, v_scale=None):
    """K3 (fp pools) or K3q (quantized pools) on the card."""
    pool = _check_pools("paged_spec_decode", q, pool_k, pool_v, block_tables, positions,
                        k_scale, v_scale)
    B, S, N, D = q.shape
    if S > MAX_QUERIES:
        raise ValueError(f"paged_spec_decode: {S} queries > {MAX_QUERIES}")
    _, bs, _, _ = pool_k.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = library("paged_attention").dst_paged_spec_decode(
        ptr(q), ptr(pool_k), ptr(pool_v), _scale_ptr(k_scale),
        _scale_ptr(v_scale), ptr(block_tables), ptr(positions), ptr(out),
        B, S, N, D, bs, block_tables.shape[1], float(scale),
        dtype_code(q.dtype), pool, stream_of(q))
    if k_scale is None:
        check(err, "paged_spec_decode")
    else:
        check(err, "paged_spec_decode_q")
    return out


def _both_or_neither(k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")


def paged_spec_decode_attention(q, pool_k, pool_v, block_tables, positions,
                                scale=None, k_scale=None, v_scale=None):
    """Speculative decode: S = k+1 query tokens per row over a blocked pool.

    q            [B, S, N, D]  queries (last committed token + k drafts)
    positions    [B, S] int32  ascending absolute position of each query;
                               query sq attends pool tokens t <= positions[b, sq]
    k_scale/v_scale [P, bs, N] fp32 per-(slot, head) dequant scales of
                               quantized pools (both or neither)
    -> [B, S, N, D] in q's type
    """
    _both_or_neither(k_scale, v_scale)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    fn = (_spec_decode_cuda if get_accelerator(q.device).use_cuda_kernels()
          else _spec_decode_reference)
    return fn(q, pool_k, pool_v, block_tables, positions, scale, k_scale,
              v_scale)


def paged_decode_attention(q, pool_k, pool_v, block_tables, seq_lens,
                           scale=None, k_scale=None, v_scale=None):
    """One decode step over a blocked KV pool.

    q            [B, N, D]     current-token queries
    pool_k/v     [P, bs, N, D] shared cache pools (q's type, or int8 / fp8
                               e4m3 when scales are given)
    block_tables [B, max_blocks] int32 pool-block ids per sequence
    seq_lens     [B] int32     live tokens per sequence (incl. current)
    k_scale/v_scale [P, bs, N] fp32 per-(slot, head) dequant scales of
                               quantized pools (both or neither)
    -> [B, N, D] in q's type
    """
    _both_or_neither(k_scale, v_scale)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    fn = (_decode_cuda if get_accelerator(q.device).use_cuda_kernels()
          else _decode_reference)
    return fn(q, pool_k, pool_v, block_tables, seq_lens, scale, k_scale,
              v_scale)
