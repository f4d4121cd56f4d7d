"""Tensor-parallel (Megatron) layers over the mesh's ``tp`` axis.

The JAX package states tensor parallelism as partition rules on the
parameters (``models/gpt_neox.py`` ``param_partition_rules``: the column /
row split of each matrix over ``tp``) and lets GSPMD insert the
collectives.  Here each rank holds its slice of every split parameter and
the layers issue the collectives themselves, PyTorch's idiom for the same
computation:

* :class:`ColumnParallelLinear` -- the weight's output rows split over
  ``tp`` (bias too): the input enters through :func:`copy_to_tensor_parallel`
  (identity forward, all-reduce of its gradient backward) and the output
  is this rank's columns;
* :class:`RowParallelLinear` -- the weight's input columns split: this
  rank's partial product goes through :func:`reduce_from_tensor_parallel`
  (all-reduce forward, identity backward), and the bias, whole on every
  rank, is added once after the all-reduce;
* :class:`VocabParallelEmbedding` -- the table's rows (the vocabulary)
  split: ids outside this rank's rows look up zeros, and the rows are
  all-reduced;
* :func:`vocab_parallel_log_likelihood` -- the cross entropy over logits
  whose vocabulary is split: the max, the sum of exponentials and the gold
  logit are each all-reduced over ``tp`` in fp32;
* :func:`gather_from_tensor_parallel` -- the whole last dim from the ranks'
  slices (the v1 engine's logits before sampling; training never gathers
  them).

:func:`shard_module` turns a whole model into its tensor-parallel form in
place, by the model's rules: each ``nn.Linear`` or ``nn.Embedding`` whose
weight a rule splits becomes the layer above, holding this rank's slice of
the same parameter objects.  Every tensor-parallel collective is logged
and staged under the op name ``tp_reduce``.
"""

import re

import torch
import torch.nn.functional as F
from torch import nn

from .. import comm

TP_OP = "tp_reduce"


def _all_reduce(x, group):
    y = x.contiguous().clone()
    return comm.all_reduce(y, group=group, log_name=TP_OP)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over ``tp`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce over ``tp`` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tensor_parallel(x, group):
    return _CopyToTP.apply(x, group) if group.size() > 1 else x


def reduce_from_tensor_parallel(x, group):
    return _ReduceFromTP.apply(x, group) if group.size() > 1 else x


def _slice(t, dim, group):
    """This rank's contiguous slice of ``t`` along ``dim`` (a copy)."""
    n = group.size()
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} is not divisible by tp={n}")
    return t.detach().chunk(n, dim)[group.rank()].contiguous()


class _Parallel(nn.Module):
    """Adopts ``lin``'s parameter objects, sliced in place."""

    def __init__(self, lin, group, weight_dim, bias_split):
        super().__init__()
        self.group = group
        self.weight = lin.weight
        self.weight.data = _slice(lin.weight, weight_dim, group)
        self.bias = getattr(lin, "bias", None)
        if self.bias is not None and bias_split:
            self.bias.data = _slice(self.bias, 0, group)
        if hasattr(lin, "config"):
            self.config = lin.config

    def _dtype(self, dtype, x):
        if dtype is not None:
            return dtype
        return self.config.dtype if hasattr(self, "config") else x.dtype


class ColumnParallelLinear(_Parallel):
    """``nn.Linear`` with this rank's rows of the weight and bias: output
    features ``[out_start, out_start + out/tp)``."""

    def __init__(self, lin, group):
        super().__init__(lin, group, 0, True)
        self.out_start = group.rank() * self.weight.shape[0]

    def forward(self, x, dtype=None, with_weight=None):
        """``x @ W_r.T + b_r`` in ``dtype`` (the model's compute type by
        default); ``with_weight(x, W_r)`` instead, for a loss that owns the
        product (the chunked cross entropy)."""
        x = copy_to_tensor_parallel(x, self.group)
        if with_weight is not None:
            return with_weight(x, self.weight)
        dt = self._dtype(dtype, x)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class RowParallelLinear(_Parallel):
    """``nn.Linear`` with this rank's columns of the weight (its input
    features ``[in_start, in_start + in/tp)``) and the whole bias."""

    def __init__(self, lin, group):
        super().__init__(lin, group, 1, False)

    def forward(self, x, dtype=None):
        dt = self._dtype(dtype, x)
        y = reduce_from_tensor_parallel(F.linear(x.to(dt), self.weight.to(dt)), self.group)
        return y if self.bias is None else y + self.bias.to(dt)


class VocabParallelEmbedding(nn.Module):
    """``nn.Embedding`` with this rank's rows ``[start, start + V/tp)``:
    other ids look up zeros, and the rows are summed over ``tp``."""

    def __init__(self, emb, group):
        super().__init__()
        self.group = group
        self.weight = emb.weight
        self.weight.data = _slice(emb.weight, 0, group)
        self.start = group.rank() * self.weight.shape[0]

    def forward(self, ids):
        local = ids - self.start
        inside = (local >= 0) & (local < self.weight.shape[0])
        rows = F.embedding(torch.where(inside, local, torch.zeros_like(local)), self.weight)
        rows = rows * inside[..., None].to(rows.dtype)
        return reduce_from_tensor_parallel(rows, self.group)


def vocab_parallel_log_likelihood(logits, labels, group, start):
    """``gold - logsumexp`` per token of fp32 ``logits`` [..., V/tp] that
    hold vocabulary ``[start, start + V/tp)``: the max (no gradient), the
    sum of exponentials and the gold logit all-reduced over ``tp``."""
    logits = logits.to(torch.float32)
    m = logits.detach().amax(-1)
    if group.size() > 1:
        comm.all_reduce(m, comm.ReduceOp.MAX, group, log_name=TP_OP)
    s = reduce_from_tensor_parallel((logits - m[..., None]).exp().sum(-1), group)
    local = labels - start
    inside = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(inside, local, torch.zeros_like(local))
                        [..., None])[..., 0]
    gold = reduce_from_tensor_parallel(gold * inside.to(gold.dtype), group)
    return gold - (m + torch.log(s))


def gather_from_tensor_parallel(x, group):
    """``x`` [..., n] from every rank of ``group``, concatenated along the
    last dim in rank order: [..., n * tp] (no gradient)."""
    if group.size() == 1:
        return x
    return comm.all_gather(x.contiguous(), group=group, axis=x.dim() - 1, log_name=TP_OP)


def partition_dims(names, rules):
    """``{name: dim}`` for each parameter name a rule splits over ``tp``
    (``rules``: ``(regex, dim)`` pairs, the first match wins)."""
    out = {}
    for name in names:
        for pattern, dim in rules:
            if re.search(pattern, name):
                if dim is not None:
                    out[name] = dim
                break
    return out


def shard_module(model, rules, group):
    """Make ``model`` tensor-parallel over ``group`` in place: every
    ``nn.Embedding`` / ``nn.Linear`` whose weight ``rules`` split becomes
    its :class:`VocabParallelEmbedding` / :class:`ColumnParallelLinear`
    (dim 0) / :class:`RowParallelLinear` (dim 1), on the same parameter
    objects, now this rank's slices; a module with
    ``tensor_parallel(group, dim)`` (MoE's stacked experts) splits itself.  A model with
    ``check_tensor_parallel(tp)`` checks first that ``tp`` splits it whole
    (Llama's KV heads).  Returns :func:`partition_dims` of the model's
    parameters."""
    if hasattr(model, "check_tensor_parallel"):
        model.check_tensor_parallel(group.size())
    dims = partition_dims([n for n, _ in model.named_parameters()], rules)
    for name, mod in list(model.named_modules()):
        dim = dims.get(f"{name}.weight")
        if dim is None or isinstance(mod, (_Parallel, VocabParallelEmbedding)):
            continue
        if hasattr(mod, "tensor_parallel"):
            # a layer that splits itself (MoE's stacked experts)
            mod.tensor_parallel(group, dim)
            continue
        if isinstance(mod, nn.Embedding) and dim == 0:
            new = VocabParallelEmbedding(mod, group)
        elif isinstance(mod, nn.Linear) and dim in (0, 1):
            if mod.bias is not None and (dims.get(f"{name}.bias") is not None) != (dim == 0):
                raise ValueError(f"{name}: a column split splits its bias, a row split "
                                 f"does not")
            new = (ColumnParallelLinear if dim == 0 else RowParallelLinear)(mod, group)
        else:
            raise ValueError(f"{name}: no tensor-parallel form of "
                             f"{type(mod).__name__} split on dim {dim}")
        owner, _, attr = name.rpartition(".")
        setattr(model.get_submodule(owner) if owner else model, attr, new)
    return dims
