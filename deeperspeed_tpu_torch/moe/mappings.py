"""Token gather and drop along the sequence dim over the ``tp`` group
(counterpart of ``deeperspeed_tpu/moe/mappings.py``, reference
``deepspeed/moe/mappings.py``).

The JAX package states both as sharding constraints; here they are the
collectives themselves: :func:`gather_tokens` all-gathers the ranks'
sequence shards along ``dim`` (its backward keeps this rank's slice of the
gradient) and :func:`drop_tokens` keeps this rank's slice (its backward
all-gathers the gradient).  Over a group of one process both are the
identity.
"""

import torch

from .. import comm


def _group(group):
    return group if group is not None else comm.get_model_parallel_group()


def _slice(x, dim, group):
    n = group.size()
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} ({x.shape[dim]}) is not divisible by tp={n}")
    return x.chunk(n, dim)[group.rank()].contiguous()


def _gather(x, dim, group):
    return comm.all_gather(x.contiguous(), group=group, axis=dim, log_name="moe_tokens")


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.dim, ctx.group), None, None


class _DropTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.group), None, None


def gather_tokens(x, dim=1, group=None):
    """Every ``tp`` rank's shard of dim ``dim``, concatenated in rank order
    (the reference's gather over the TP group)."""
    group = _group(group)
    return x if group.size() == 1 else _GatherTokens.apply(x, dim, group)


def drop_tokens(x, dim=1, group=None):
    """This ``tp`` rank's slice of dim ``dim`` (the reference's per-rank
    slice)."""
    group = _group(group)
    return x if group.size() == 1 else _DropTokens.apply(x, dim, group)
