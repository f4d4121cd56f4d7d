"""Stacked experts (counterpart of ``deeperspeed_tpu/moe/experts.py``).

The JAX package vmaps one ``ExpertMLP`` over a leading expert dim, so each
expert weight is one stacked parameter ``[E, ...]`` whose leading dim the
``ep`` axis shards.  Here the same stacked parameters, in torch's ``[out,
in]`` layout, and the same computation as batched products: ``[E_local,
C, H] -> [E_local, C, H]`` through ``dense_h_to_4h``, GELU (tanh) and
``dense_4h_to_h``.  The model holds every expert; the training engine
keeps its ``ep`` rank's ``E / ep`` of them (:meth:`Experts.shard`).

Under tensor parallelism each expert splits as the JAX package's
``P("ep", None, "tp")`` says (``StackedLinear.tensor_parallel``):
``dense_h_to_4h`` by its output features (a column split, its bias too),
``dense_4h_to_h`` by its input features (a row split: the partial products
are all-reduced over ``tp``, then the whole bias is added).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor_parallel import (_slice, copy_to_tensor_parallel,
                                        reduce_from_tensor_parallel)


class StackedLinear(nn.Module):
    """``weight [E, out, in]`` and ``bias [E, out]``: one ``nn.Linear`` an
    expert, applied to ``x [E, C, in]`` by one batched product."""

    def __init__(self, num_experts, in_features, out_features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_experts, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(num_experts, out_features))
        self.group, self.split = None, None

    @torch.no_grad()
    def tensor_parallel(self, group, dim):
        """Keep this ``tp`` rank's slice of every expert: ``dim`` 1 splits
        the output features (and the bias), 2 the input features."""
        if dim not in (1, 2):
            raise ValueError(f"a stacked linear splits on dim 1 or 2, not {dim}")
        self.group, self.split = group, dim
        self.weight.data = _slice(self.weight, dim, group)
        if dim == 1:
            self.bias.data = _slice(self.bias, 1, group)

    @torch.no_grad()
    def reset_parameters(self, gen):
        """Flax's Dense defaults, each expert drawn on its own: lecun-normal
        kernels (truncated at two standard deviations), zero biases."""
        std = (1.0 / math.sqrt(self.weight.shape[-1])) / .87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
        self.bias.zero_()

    def forward(self, x, dtype):
        w, b = self.weight.to(dtype).transpose(1, 2), self.bias.to(dtype)[:, None, :]
        if self.split == 1:
            x = copy_to_tensor_parallel(x, self.group)
        elif self.split == 2:
            return reduce_from_tensor_parallel(torch.bmm(x.to(dtype), w), self.group) + b
        return torch.baddbmm(b, x.to(dtype), w)


class Experts(nn.Module):
    """The default FFN experts (h -> ffn_dim -> h, GELU) stacked over a
    leading expert dim; the products run in ``dtype``.  ``num_local`` of
    the ``num_experts`` live here, from ``first`` on."""

    def __init__(self, num_experts, hidden_size, ffn_dim, dtype=torch.float32):
        super().__init__()
        self.num_experts = self.num_local = num_experts
        self.first = 0
        self.dtype = dtype
        self.dense_h_to_4h = StackedLinear(num_experts, hidden_size, ffn_dim)
        self.dense_4h_to_h = StackedLinear(num_experts, ffn_dim, hidden_size)

    def reset_parameters(self, gen):
        self.dense_h_to_4h.reset_parameters(gen)
        self.dense_4h_to_h.reset_parameters(gen)

    @torch.no_grad()
    def shard(self, ep_rank, ep_size):
        """Keep experts ``[ep_rank * E / ep_size, (ep_rank + 1) * E /
        ep_size)`` (the ``ep`` rank's), on the same parameter objects."""
        if self.num_local != self.num_experts:
            raise ValueError("the experts are sharded already")
        if self.num_experts % ep_size:
            raise ValueError(f"{self.num_experts} experts do not split over ep={ep_size}")
        self.num_local = self.num_experts // ep_size
        self.first = ep_rank * self.num_local
        for p in self.parameters():
            p.data = p.data[self.first:self.first + self.num_local].clone()

    def forward(self, x):
        h = F.gelu(self.dense_h_to_4h(x, self.dtype), approximate="tanh")
        return self.dense_4h_to_h(h, self.dtype)
