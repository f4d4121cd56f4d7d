"""Pipeline-partitioned GPT-NeoX (counterpart of
``deeperspeed_tpu/models/gpt_neox_pipe.py``).

``GPTNeoXPipe(config, num_stages)`` cuts :class:`GPTNeoX` into stages of
``num_layers / num_stages`` blocks: ``embed_in`` lives on the first stage,
``final_layer_norm`` and ``embed_out`` on the last.  The blocks are
GPT-NeoX's own, so the layer math and its kernels (K1 / K8 LayerNorm, K5-K7
flash attention on the card) are the flat model's.

For a ``PipelineModule`` of GPT-NeoX layers (the interpreted engine's
graphs, a tied embedding and head among them): :class:`EmbedLayer`,
:class:`BlockLayer` (a block called on its input alone), the final
``ModelLayerNorm`` and :func:`tied_head`, the embedding table used as the
output head of a ``TiedLayerSpec``.
"""

import torch

import math

import torch.nn.functional as F
from torch import nn

from .gpt_neox import (TP_RULES, GPTNeoX, GPTNeoXBlock, _remat_block, pipe_params_from_jax,
                       pipe_params_to_jax)
from .pipe_base import StagePipeBase


class GPTNeoXPipe(StagePipeBase):
    FLAT = GPTNeoX
    EMBED = ("embed_in",)
    HEAD = ("final_layer_norm", "embed_out")
    NO_CAST = [r"embed_in\.weight"]
    TP_RULES = TP_RULES

    def __init__(self, config, num_stages, device=None, seed=0, draw_on_device=False):
        if config.has_moe:
            # the JAX package's refusal, in its words
            raise NotImplementedError(
                "MoE under the compiled pipeline is not supported yet: stages "
                "scan a homogeneous block stack, and MoE layers are "
                "heterogeneous. Use pp=1 (ZeRO + ep) for MoE models.")
        if getattr(config, "seq_parallel_mode", None) in ("ulysses", "ring"):
            raise NotImplementedError(
                "sequence parallelism inside the compiled pipeline's manual "
                "region is not wired up yet; use pp=1 for sp>1 runs.")
        super().__init__(config, num_stages, device, seed)
        self.draw_on_device = draw_on_device

    def _draw_device(self, device):
        """The CPU, or the card under ``draw_on_device`` (as
        :class:`GPTNeoX`)."""
        return device if self.draw_on_device and device.type == "cuda" \
            else torch.device("cpu")

    def _embed(self, stage, tokens):
        return stage.embed_in(tokens).to(stage.config.dtype)

    def _blocks(self, stage, x, positions, rng):
        remat = stage.config.remat and torch.is_grad_enabled()
        for blk in stage.layers:
            x = (_remat_block(blk, x, positions, rng) if remat
                 else blk(x, positions, rng=rng))
        return x

    def _head(self, stage, x):
        return stage.embed_out(stage.final_layer_norm(x))

    def params_from_jax(self, tree, stage_id):
        return pipe_params_from_jax(tree, stage_id, self.num_stages)

    def params_to_jax(self, stage_dicts):
        return pipe_params_to_jax(stage_dicts)


class EmbedLayer(nn.Module):
    """GPT-NeoX's input embedding as a layer: ``embed_in`` [V, H], drawn
    N(0, 1/H) from the global generator, looked up in its type (fp32 in
    training) and cast to ``config.dtype``."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.embed_in = nn.Embedding(config.vocab_size, config.hidden_size)
        nn.init.normal_(self.embed_in.weight, 0.0, 1.0 / math.sqrt(config.hidden_size))

    def forward(self, input_ids):
        return self.embed_in(input_ids).to(self.config.dtype)


def tied_head(module, x):
    """An :class:`EmbedLayer`'s table as the output head (``forward_fn`` of
    its ``TiedLayerSpec``): logits ``x @ embed_in.T`` in ``x``'s type."""
    return F.linear(x, module.embed_in.weight.to(x.dtype))


class BlockLayer(GPTNeoXBlock):
    """A GPT-NeoX block called on ``x`` [B, S, H] alone (positions
    ``0 .. S-1``)."""

    def forward(self, x):
        B, S = x.shape[:2]
        return super().forward(x, torch.arange(S, device=x.device).expand(B, S))
