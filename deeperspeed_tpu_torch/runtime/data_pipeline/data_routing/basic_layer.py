"""Random layerwise token dropping (random-LTD) ops (counterpart of
``deeperspeed_tpu/runtime/data_pipeline/data_routing/basic_layer.py``).

Middle transformer blocks process a random subset of ``k`` tokens of each
row; the other tokens skip the block and are written back in place after
it.  Both directions are one ``gather`` / ``scatter``; the subset is drawn
from the caller's ``torch.Generator``.

Usage inside a model::

    sub, idx = random_ltd_gather(x, k, rng)          # [B, k, H], [B, k]
    sub = block(sub, take_tokens(positions, idx))    # the block on the subset
    x = random_ltd_scatter(x, sub, idx)              # [B, S, H]
"""

import torch


def sample_token_indices(rng, batch, seq_len, k, device=None):
    """Per-row sorted random k-subset of [0, seq_len) (sorted keeps the
    causal order): the first k of an argsort of uniforms, as the JAX
    package draws them."""
    keys = torch.rand(batch, seq_len, generator=rng, device=device)
    return keys.argsort(dim=-1)[:, :k].sort(dim=-1).values


def take_tokens(x, idx):
    """Entries ``idx`` [B, k] along dim 1 of ``x`` ([B, S] or [B, S, H])."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def random_ltd_gather(x, k, rng):
    """Select k random tokens per row: [B, S, H] -> ([B, k, H], idx [B, k])."""
    B, S, _ = x.shape
    idx = sample_token_indices(rng, B, S, k, x.device)
    return take_tokens(x, idx), idx


def random_ltd_scatter(x_full, x_sub, idx):
    """``x_full`` with the rows ``idx`` of each sequence replaced by ``x_sub``."""
    return x_full.scatter(1, idx[..., None].expand(*idx.shape, x_full.shape[-1]),
                          x_sub)
