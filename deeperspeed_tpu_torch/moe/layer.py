"""The user-facing MoE layer (counterpart of
``deeperspeed_tpu/moe/layer.py``, reference ``deepspeed/moe/layer.py:16``).

:class:`MoE` is the :class:`~.sharded_moe.MOELayer` over its own gate and
stacked experts, plus Residual-MoE (``use_residual``): a dense MLP beside
the experts and a learned 2-way ``coefficient`` that mixes the two.  Its
parameters are named as the JAX package's tree nests them under the
block's ``moe``: ``experts``, ``gate.wg``, ``mlp`` and ``coefficient``.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .experts import Experts
from .sharded_moe import MOELayer, TopKGate


def _linear(lin, x, dtype):
    """``lin`` applied in ``dtype``; a tensor-parallel linear (the engine's
    ``shard_module`` made it one) through its own forward."""
    if hasattr(lin, "group"):
        return lin(x, dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class ExpertMLP(nn.Module):
    """The residual branch: one dense expert (h -> ffn_dim -> h, GELU)."""

    def __init__(self, hidden_size, ffn_dim, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dense_h_to_4h = nn.Linear(hidden_size, ffn_dim)
        self.dense_4h_to_h = nn.Linear(ffn_dim, hidden_size)

    def forward(self, x):
        dt = self.dtype
        h = F.gelu(_linear(self.dense_h_to_4h, x, dt), approximate="tanh")
        return _linear(self.dense_4h_to_h, h, dt)


class MoE(MOELayer):
    """Sparse MoE block: gate -> dispatch -> experts -> combine.  Returns
    ``(output, l_aux, exp_counts)`` like the reference forward
    (``layer.py:115``)."""

    def __init__(self, hidden_size, num_experts=1, ffn_dim: Optional[int] = None, k=1,
                 capacity_factor=1.0, eval_capacity_factor=1.0, min_capacity=4,
                 use_residual=False, noisy_gate_policy=None, drop_tokens=True,
                 use_rts=True, dtype=torch.float32, quantized_alltoall=False,
                 quantized_group_size=128, quantized_alltoall_dtype="int8"):
        ffn = ffn_dim or 4 * hidden_size
        super().__init__(
            TopKGate(hidden_size, num_experts, k=k, capacity_factor=capacity_factor,
                     eval_capacity_factor=eval_capacity_factor, min_capacity=min_capacity,
                     noisy_gate_policy=noisy_gate_policy, drop_tokens=drop_tokens,
                     use_rts=use_rts),
            Experts(num_experts, hidden_size, ffn, dtype),
            quantized_alltoall=quantized_alltoall, quantized_group_size=quantized_group_size,
            quantized_alltoall_dtype=quantized_alltoall_dtype)
        self.use_residual = use_residual
        self.dtype = dtype
        if use_residual:
            self.mlp = ExpertMLP(hidden_size, ffn, dtype)
            self.coefficient = nn.Linear(hidden_size, 2)

    def set_dtype(self, dtype):
        """The compute type of the products (the gate stays fp32)."""
        self.dtype = self.experts.dtype = dtype
        if self.use_residual:
            self.mlp.dtype = dtype

    def forward(self, x, used_token=None, train=True, rng=None):
        out, l_aux, exp_counts = super().forward(x, used_token=used_token, train=train,
                                                 rng=rng)
        if self.use_residual:
            dt = self.dtype
            mlp_out = self.mlp(x)
            coef = F.linear(x.to(dt), self.coefficient.weight.to(dt),
                            self.coefficient.bias.to(dt))
            coef = torch.softmax(coef, dim=-1)
            out = out * coef[..., 0:1] + mlp_out * coef[..., 1:2]
        return out, l_aux, exp_counts
