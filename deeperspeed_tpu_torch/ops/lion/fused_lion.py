"""Fused Lion: kernel B7 and its plain version (counterpart of
``deeperspeed_tpu/ops/lion/fused_lion.py``).

:func:`scale_by_fused_lion` keeps the moment in one flat fp32 buffer, a
view per parameter in the parameters' order, so one launch of B7 covers
every parameter.  The update rewrites the gradients in place with
u = sign(b1 m + (1-b1) g); the moment becomes b2 m + (1-b2) g.

For CUDA tensors :func:`fused_lion_` launches ``dst_fused_lion`` of
``csrc/fused_optimizers.cu``; for CPU tensors it runs
:func:`_lion_leaf_plain`, the same products and sums in the same order,
each rounded on its own, so the two agree bit for bit.  As ``jnp.sign``
gives them, the sign of 0 is 0 and the sign of NaN is NaN (``torch.sign``
gives 0 for NaN, so the plain version puts the NaN back).
"""

import torch

from ...accelerator import get_accelerator
from ...runtime.optimizers import GradientTransformation
from .. import multi_tensor
from ..adam.fused_adam import flat_zeros_like
from ..cuda_utils import check, library, ptr, stream_of


def _lion_leaf_plain(g, m, b1, b2):
    """Plain version of B7 over lists of fp32 tensors, in place
    (``_lion_leaf_jnp`` of the JAX package)."""
    u = torch._foreach_mul(m, b1)
    torch._foreach_add_(u, torch._foreach_mul(g, 1.0 - b1))
    u = [torch.where(c.isnan(), c, c.sign()) for c in u]
    torch._foreach_mul_(m, b2)
    torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b2))
    torch._foreach_copy_(g, u)


def _lion_cuda(g, m, b1, b2, cache=None):
    """B7 on the card: one launch over every (g, m) pair."""
    table, n_entries, n_chunks, write_back = multi_tensor.prepare(
        "fused_lion", [g, m], cache)
    if n_chunks == 0:
        return
    err = library("fused_optimizers").dst_fused_lion(
        ptr(table), n_entries, n_chunks, b1, 1.0 - b1, b2, 1.0 - b2,
        stream_of(table))
    check(err, "fused_lion")
    multi_tensor.finish(write_back)


def fused_lion_(g, m, b1=0.9, b2=0.99, cache=None):
    """One Lion step over lists of fp32 tensors, in place: ``g`` becomes
    the update, ``m`` the new moment.  ``cache``: a dict kept by a caller
    that passes the same tensors every step, for
    :func:`multi_tensor.prepare`."""
    if not g:
        return
    if get_accelerator(g[0].device).use_cuda_kernels():
        _lion_cuda(g, m, b1, b2, cache)
    else:
        _lion_leaf_plain(g, m, b1, b2)


def scale_by_fused_lion(b1=0.9, b2=0.99):
    """optax ``scale_by_lion``'s function through B7: one launch a step."""
    cache = {}      # the device table, built at the first step

    def init(params):
        return flat_zeros_like(params)

    def update(updates, state, params=None):
        names = list(updates)
        fused_lion_([updates[n] for n in names], [state[n] for n in names], b1, b2,
                    cache)
        return updates, state

    def restore(state, saved, load):
        load(saved["mu"], state)       # in place: ``cache`` holds its address
        return state

    # the JAX package's ScaleByFusedLionState(mu)
    return GradientTransformation(init, update, lambda state, tree: {"mu": tree(state)},
                                  restore)
