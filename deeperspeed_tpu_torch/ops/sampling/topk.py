"""Sorted top-k over logit rows: kernel K4 and its plain version
(counterpart of ``deeperspeed_tpu/ops/sampling/topk.py``).

Decode-time sampling needs only the k largest logits of each row, sorted
descending (the top-k filter threshold is the k-th value).  For a CUDA
tensor :func:`sorted_topk` launches the hand-written kernel of
``csrc/topk.cu``: up to :data:`K_MAX` a radix select over the row's keys,
then a sort of the few candidates, at any vocabulary size; above it the
port's first kernel, k rounds of arg-max over the row held in shared
memory, which takes rows of up to about 56K values.  For a CPU tensor it
runs :func:`_topk_reference`, k rounds of arg-max in PyTorch.

Both follow ``lax.top_k``: ties go to the lowest index (-0.0 and 0.0 tie),
and a taken slot is marked by a flag, so it is never chosen again even in a
row whose values are <= -1e30 (the TPU kernel's -1e30 overwrite would
choose it again).  A row that holds a NaN gives NaN and index V in every
output, as the TPU kernel's NaN-propagating max does.
"""

import torch

from ...accelerator import get_accelerator
from ..cuda_utils import check, library, ptr, require_cuda, stream_of


# the largest k the kernel's radix select takes (csrc/topk.cu K_MAX)
K_MAX = 2048


def _topk_reference(x, k):
    """Plain version of K4: k arg-max rounds over the untaken slots."""
    rows, V = x.shape
    x = x.to(torch.float32)
    cols = torch.arange(V, device=x.device).expand(rows, V)
    taken = torch.zeros(rows, V, dtype=torch.bool, device=x.device)
    neg = torch.tensor(float("-inf"), device=x.device)
    vals, idxs = [], []
    for _ in range(k):
        m = torch.where(taken, neg, x).amax(dim=1, keepdim=True)   # [rows, 1]
        hit = ~taken & (x == m)
        first = torch.where(hit, cols, V).amin(dim=1, keepdim=True)
        vals.append(m)
        idxs.append(first)
        taken = taken | (cols == first)
    return (torch.cat(vals, dim=1),
            torch.cat(idxs, dim=1).to(torch.int32))


def _topk_cuda(x, k):
    """K4 on the card.  The kernel reads fp32 rows: another float type, or a
    strided view, is widened and made contiguous first, as the reference
    casts the row to fp32 (exact, so values, ties and order are kept)."""
    x = x.to(torch.float32).contiguous()
    require_cuda("sorted_topk", x)
    rows, V = x.shape
    # above K_MAX a row too long for shared memory makes the launch fail, and raise
    lib = library("topk")
    vals = torch.empty(rows, k, dtype=torch.float32, device=x.device)
    idx = torch.empty(rows, k, dtype=torch.int32, device=x.device)
    if rows == 0:
        return vals, idx
    err = lib.dst_sorted_topk(ptr(x), ptr(vals), ptr(idx), rows, V, k,
                              stream_of(x))
    check(err, "sorted_topk")
    return vals, idx


def sorted_topk(x, k):
    """Top-k values (descending) and their indices per row.

    x [rows, V] of any float type, taken as fp32 -> (vals [rows, k] float32,
    idx [rows, k] int32)

    On the card any V is taken up to k = :data:`K_MAX`; above it the row
    must fit in shared memory (V up to about 56K), or the launch raises.
    """
    rows, V = x.shape
    k = int(k)
    if k < 1 or k > V:
        raise ValueError(f"k={k} out of range for vocab {V}")
    if get_accelerator(x.device).use_cuda_kernels():
        return _topk_cuda(x, k)
    return _topk_reference(x, k)
