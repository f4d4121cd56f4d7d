"""Fused Adam: kernel B6 and its plain version (counterpart of
``deeperspeed_tpu/ops/adam/fused_adam.py`` and ``pallas_adam.py``).

:func:`scale_by_fused_adam` is the optimizer's core as a transformation of
the port's form (``runtime/optimizers.py``): it keeps the moments in one
flat fp32 buffer each, a view per parameter in the order of the
parameters it was initialised with (the engine's ``_order``, the order of
its flat master and gradient buffers), so one launch of B6 covers every
parameter.  The update rewrites the gradients in place with
u = (m'/bc1) / (sqrt(v'/bc2) + eps), the port's convention for updates.

For CUDA tensors :func:`fused_adam_` launches ``dst_fused_adam`` of
``csrc/fused_optimizers.cu``; for CPU tensors it runs
:func:`_adam_leaf_update_plain`, the same products and sums in the same
order with ``torch._foreach_*``, each rounded on its own (so m' and v'
equal the kernel's bit for bit).
"""

import torch

from ...accelerator import get_accelerator
from ...runtime.optimizers import GradientTransformation, _bias_correction
from .. import multi_tensor
from ..cuda_utils import check, library, ptr, stream_of


def _adam_leaf_update_plain(g, m, v, bc1, bc2, b1, b2, eps):
    """Plain version of B6 over lists of fp32 tensors, in place: ``m`` and
    ``v`` take m' and v', ``g`` takes the update (``_adam_leaf_update_jnp``
    of the JAX package, with bc1 and bc2 given)."""
    gm = torch._foreach_mul(g, 1.0 - b1)
    gv = torch._foreach_mul(g, 1.0 - b2)
    torch._foreach_mul_(gv, g)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, gm)
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, gv)
    den = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    u = torch._foreach_div(m, bc1)
    torch._foreach_div_(u, den)
    torch._foreach_copy_(g, u)


def _adam_cuda(g, m, v, bc1, bc2, b1, b2, eps, cache=None):
    """B6 on the card: one launch over every (g, m, v) triple."""
    table, n_entries, n_chunks, write_back = multi_tensor.prepare(
        "fused_adam", [g, m, v], cache)
    if n_chunks == 0:
        return
    err = library("fused_optimizers").dst_fused_adam(
        ptr(table), n_entries, n_chunks, b1, 1.0 - b1, b2, 1.0 - b2, eps,
        bc1, bc2, stream_of(table))
    check(err, "fused_adam")
    multi_tensor.finish(write_back)


def fused_adam_(g, m, v, count, b1=0.9, b2=0.999, eps=1e-8, cache=None):
    """One Adam step over lists of fp32 tensors, in place: ``g`` becomes the
    update, ``m`` and ``v`` the new moments.  ``count`` is the step number
    (1 for the first), its bias corrections taken on the host in fp32.
    ``cache``: a dict kept by a caller that passes the same tensors every
    step, for :func:`multi_tensor.prepare`."""
    if not g:
        return
    bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
    if get_accelerator(g[0].device).use_cuda_kernels():
        _adam_cuda(g, m, v, bc1, bc2, b1, b2, eps, cache)
    else:
        _adam_leaf_update_plain(g, m, v, bc1, bc2, b1, b2, eps)


def flat_zeros_like(params):
    """Zeros in one flat fp32 buffer, a view per tensor of ``params`` (a
    dict) in its order."""
    sizes = [p.numel() for p in params.values()]
    dev = next(iter(params.values())).device if params else None
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    views, off = {}, 0
    for (name, p), n in zip(params.items(), sizes):
        views[name] = flat[off:off + n].view(p.shape)
        off += n
    return views


def scale_by_fused_adam(b1=0.9, b2=0.999, eps=1e-8):
    """optax ``scale_by_adam``'s function through B6: one launch a step."""
    cache = {}      # the device table, built at the first step

    def init(params):
        return {"count": 0, "mu": flat_zeros_like(params), "nu": flat_zeros_like(params)}

    def update(updates, state, params=None):
        names = list(updates)
        count = state["count"] + 1
        fused_adam_([updates[n] for n in names], [state["mu"][n] for n in names],
                    [state["nu"][n] for n in names], count, b1, b2, eps, cache)
        return updates, {**state, "count": count}

    return GradientTransformation(init, update)
