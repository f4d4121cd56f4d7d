"""Small models for tests and pipeline layer specs (counterpart of
``deeperspeed_tpu/models/simple.py``).

Parameters carry flax's names and layouts (a ``Dense`` kernel is
``[in, out]``), so a flax tree of the same model maps onto the state dict
by its '/'-joined paths and checkpoints of either package load here.

* :class:`SimpleMLP` / :class:`SimpleModel`: ``nlayers`` Dense + ReLU,
  then ``Dense(1)``; the mean-squared-error loss.
* :class:`InProj`, :class:`Block`, :class:`OutProj`: the layers of the MLP
  stack the interpreted pipeline is held against (``proj``, ``tanh``
  residual ``fc``, ``head``), for ``LayerSpec``; :class:`Embed` a flax
  ``nn.Embed`` (``embedding`` [V, H]) for a ``TiedLayerSpec``, with
  :func:`embed_decode` its use as the output head; :func:`mse_loss` and
  :func:`ce_loss` the stacks' losses.
"""

import math

import numpy as np
import torch
from torch import nn


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, the kernel ``[in, out]``
    drawn lecun-normal (truncated at two standard deviations), the bias
    zero."""

    def __init__(self, in_features, out_features, use_bias=True):
        super().__init__()
        std = (1.0 / math.sqrt(in_features)) / .87962566103423978
        self.kernel = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(in_features, out_features), 0.0, std, -2 * std, 2 * std))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def forward(self, x):
        y = x.to(self.kernel.dtype) @ self.kernel
        return y if self.bias is None else y + self.bias


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding`` [num_embeddings, features], drawn
    N(0, 1/features)."""

    def __init__(self, num_embeddings, features):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.randn(num_embeddings, features) / math.sqrt(features))

    def forward(self, ids):
        return self.embedding[ids.long()]


def embed_decode(module, x):
    """A tied :class:`Embed` as the output head: ``x @ embedding.T``."""
    return x @ module.embedding.t().to(x.dtype)


class InProj(nn.Module):
    def __init__(self, in_features=16, hidden=16):
        super().__init__()
        self.proj = Dense(in_features, hidden)

    def forward(self, x):
        return self.proj(x)


class Block(nn.Module):
    def __init__(self, hidden=16):
        super().__init__()
        self.fc = Dense(hidden, hidden)

    def forward(self, x):
        return x + self.fc(torch.tanh(x))


class OutProj(nn.Module):
    def __init__(self, hidden=16, out_features=8):
        super().__init__()
        self.head = Dense(hidden, out_features)

    def forward(self, x):
        return self.head(x)


def mse_loss(out, labels):
    return torch.mean(torch.square(out.to(torch.float32) - labels.to(torch.float32)))


def ce_loss(logits, labels):
    """Mean cross entropy of integer ``labels`` under fp32 ``logits``."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long()).mean()


class SimpleMLP(nn.Module):
    """``hidden_dim -> hidden_dim`` MLP regression model (flax names
    ``Dense_0 .. Dense_<nlayers>``)."""

    def __init__(self, hidden_dim=10, nlayers=2, device="cpu"):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.nlayers = nlayers
        for i in range(nlayers):
            self.add_module(f"Dense_{i}", Dense(hidden_dim, hidden_dim))
        self.add_module(f"Dense_{nlayers}", Dense(hidden_dim, 1))
        self.to(device)

    def forward(self, x):
        for i in range(self.nlayers):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.nlayers}")(x)

    def example_batch(self, batch_size=8, seed=0):
        rng = np.random.default_rng(seed)
        return {"x": torch.from_numpy(rng.standard_normal((batch_size, self.hidden_dim),
                                                          np.float32)),
                "y": torch.from_numpy(rng.standard_normal((batch_size, 1), np.float32))}

    def loss_fn(self):
        def loss(model, batch, rng=None, **_):
            return mse_loss(model(batch["x"]), batch["y"])

        return loss


class SimpleModel(SimpleMLP):
    """The reference test zoo's name for :class:`SimpleMLP`."""
