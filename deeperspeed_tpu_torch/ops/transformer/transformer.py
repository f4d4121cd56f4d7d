"""The legacy fused transformer encoder layer (counterpart of
``deeperspeed_tpu/ops/transformer/transformer.py``, itself the reference's
``DeepSpeedTransformerLayer`` / ``DeepSpeedTransformerConfig``).

The layer runs on the port's kernels: LayerNorm K1/K8 (``normalize.py``),
tanh-GELU B9 (``activations.py``), and attention through
``ops/attention/core.py`` -- flash K5-K7 on the card for an unmasked call
without dropout in fp32 or bf16, the dense path otherwise (a key-padding
``attention_mask``, attention dropout, or fp16, which the flash kernels do
not take), the JAX package's dispatch rule.  The products are
``torch.nn.functional.linear``, as the JAX package left them to XLA.

Precision follows flax: the four ``Dense`` products run in the config's
``dtype`` (fp16 when ``fp16``) from fp32 parameters, input and weights cast
to it; the LayerNorm parameters and statistics stay fp32; a residual sum
of an fp32 stream and an fp16 branch promotes to fp32.  Dropout (hidden
and attention) draws from the caller's ``torch.Generator`` (``rng``); with
``rng=None`` the layer is deterministic.

:func:`layer_params_from_jax` carries one layer's flax parameters across.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...accelerator import resolve_device
from ..attention.core import dot_product_attention, keep_mask
from .activations import gelu_tanh
from .normalize import layer_norm


@dataclasses.dataclass(frozen=True)
class DeeperSpeedTransformerConfig:
    """Config surface of the reference ``DeepSpeedTransformerConfig``.

    The CUDA-specific knobs (``stochastic_mode``, ``attn_dropout_checkpoint``,
    ``normalize_invertible``, ``gelu_checkpoint``) are accepted, as in the
    JAX package, and change nothing."""

    batch_size: int = -1
    hidden_size: int = 768
    intermediate_size: int = -1
    heads: int = 12
    attn_dropout_ratio: float = 0.1
    hidden_dropout_ratio: float = 0.1
    num_hidden_layers: int = -1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    seed: int = -1
    fp16: bool = False
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    return_tuple: bool = False
    training: bool = True

    @property
    def ffn_size(self):
        return (self.intermediate_size if self.intermediate_size > 0
                else 4 * self.hidden_size)

    @property
    def dtype(self):
        return torch.float16 if self.fp16 else torch.float32


class _FusedLN(nn.Module):
    def __init__(self, features, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


class _Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` from its own parameters (flax
    ``nn.Dense(dtype=...)``)."""

    def __init__(self, n_in, n_out, dtype):
        super().__init__(n_in, n_out)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _dropout(x, rate, rng):
    """flax ``nn.Dropout``: x / (1 - rate) where kept, else 0."""
    if rate == 0.0 or rng is None:
        return x
    keep = keep_mask(x.shape, rate, rng, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class DeeperSpeedTransformerLayer(nn.Module):
    """Post- or pre-LN encoder layer: attention, then the FFN, each with a
    residual.  Parameters are made from ``seed`` (``config.seed`` when it
    is set, else 0) as flax makes them: truncated-normal LeCun kernels, zero
    biases, unit LayerNorm scales; ``device`` is CUDA unless the caller
    passes ``device="cpu"``."""

    def __init__(self, config, device=None, seed=None):
        super().__init__()
        self.config = cfg = config
        h, dt = cfg.hidden_size, cfg.dtype
        if h % cfg.heads:
            raise ValueError(f"hidden_size {h} is not a multiple of heads {cfg.heads}")
        self.attn_ln = _FusedLN(h, cfg.layer_norm_eps)
        self.ffn_ln = _FusedLN(h, cfg.layer_norm_eps)
        self.qkv = _Dense(h, 3 * h, dt)
        self.attn_out = _Dense(h, h, dt)
        self.ffn_in = _Dense(h, cfg.ffn_size, dt)
        self.ffn_out = _Dense(cfg.ffn_size, h, dt)
        if seed is None:
            seed = cfg.seed if cfg.seed >= 0 else 0
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for dense in (self.qkv, self.attn_out, self.ffn_in, self.ffn_out):
                # flax lecun_normal: variance 1 / fan_in, truncated at 2 std
                std = (1.0 / dense.in_features) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(dense.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=gen)
                dense.bias.zero_()
        self.to(resolve_device(device))

    def _attend(self, x, attention_mask, rng):
        cfg = self.config
        B, S, h = x.shape
        qkv = self.qkv(x).reshape(B, S, cfg.heads, 3 * (h // cfg.heads))
        q, k, v = qkv.chunk(3, dim=-1)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].to(torch.bool)
        rate = cfg.attn_dropout_ratio if rng is not None else 0.0
        out = dot_product_attention(q, k, v, mask=mask, causal=False, dropout_rate=rate,
                                    generator=rng)
        return self.attn_out(out.reshape(B, S, h))

    def _ffn(self, x):
        return self.ffn_out(gelu_tanh(self.ffn_in(x)))

    def forward(self, hidden_states, attention_mask=None, rng=None):
        """[B, S, hidden] -> [B, S, hidden].  ``attention_mask`` [B, S] keeps
        the keys where it is nonzero; ``rng`` (a ``torch.Generator``) turns
        dropout on."""
        cfg = self.config
        rate = cfg.hidden_dropout_ratio
        if cfg.pre_layer_norm:
            x = hidden_states + _dropout(
                self._attend(self.attn_ln(hidden_states), attention_mask, rng), rate, rng)
            x = x + _dropout(self._ffn(self.ffn_ln(x)), rate, rng)
        else:
            x = self.attn_ln(hidden_states + _dropout(
                self._attend(hidden_states, attention_mask, rng), rate, rng))
            x = self.ffn_ln(x + _dropout(self._ffn(x), rate, rng))
        return (x,) if cfg.return_tuple else x


_LAYER_NORMS = ("attn_ln", "ffn_ln")
_DENSES = ("qkv", "attn_out", "ffn_in", "ffn_out")


def layer_params_from_jax(tree) -> dict:
    """A state dict for :class:`DeeperSpeedTransformerLayer` from the flax
    parameters of one layer, as nested dicts of numpy arrays
    (``jax.device_get(params)``); needs no JAX.  Each ``Dense`` kernel
    [in, out] is transposed into ``nn.Linear.weight`` [out, in]; the qkv
    kernel keeps its head-interleaved columns (each head's q, k and v side
    by side), which the layer splits as the JAX layer does.  Raises if a
    leaf of ``tree`` is left unmapped."""
    sd, used = {}, set()

    def leaf(module, name, transpose=False):
        used.add(f"{module}/{name}")
        a = np.asarray(tree[module][name], np.float32)
        return torch.from_numpy(np.array(a.T if transpose else a, order="C"))

    for ln in _LAYER_NORMS:
        sd[f"{ln}.weight"] = leaf(ln, "scale")
        sd[f"{ln}.bias"] = leaf(ln, "bias")
    for dense in _DENSES:
        sd[f"{dense}.weight"] = leaf(dense, "kernel", transpose=True)
        sd[f"{dense}.bias"] = leaf(dense, "bias")
    leaves = {f"{m}/{n}" for m, node in tree.items() for n in node}
    if leaves - used:
        raise ValueError(f"layer_params_from_jax: unmapped leaves {sorted(leaves - used)}")
    return sd
