"""Pipeline-partitioned Llama family: Llama-2, Mistral (grouped-query
attention, the sliding window) and untied OPT (counterpart of
``deeperspeed_tpu/models/llama_pipe.py``).

``LlamaPipe(config, num_stages)`` cuts :class:`Llama` into stages: the
token (and OPT's learned position) embeddings on the first stage, the
final norm and ``lm_head`` on the last; the blocks are Llama's own, on K1
/ K8 (RMSNorm or LayerNorm) and K5-K7 (flash attention).  Tied embeddings
are refused, as in the JAX package.
"""

import torch

from .llama import TP_RULES, Llama, pipe_params_from_jax, pipe_params_to_jax
from .pipe_base import StagePipeBase
from ..sequence import sequence_positions
from ..utils.recompute import checkpoint_replaying


class LlamaPipe(StagePipeBase):
    FLAT = Llama
    EMBED = ("embed_tokens", "embed_positions")
    HEAD = ("final_norm", "lm_head")
    NO_CAST = [r"embed_tokens\.weight", r"embed_positions\.weight"]
    TP_RULES = TP_RULES

    def __init__(self, config, num_stages, device=None, seed=0):
        if config.tie_embeddings:
            # the JAX package's refusal, in its words
            raise NotImplementedError(
                "tie_embeddings under the compiled pipeline is not supported: "
                "the tied table would have to live on both the first and last "
                "stage. Use the interpreted executor (TiedLayerSpec) or an "
                "untied config.")
        super().__init__(config, num_stages, device, seed)

    def _embed(self, stage, tokens):
        cfg = stage.config
        x = stage.embed_tokens(tokens).to(cfg.dtype)
        if cfg.learned_positions:
            B, S = tokens.shape
            positions = sequence_positions(stage, B, S, tokens.device)
            x = x + stage.embed_positions(positions).to(cfg.dtype)
        return x

    def _blocks(self, stage, x, positions, rng):
        remat = stage.config.remat and torch.is_grad_enabled()
        for blk in stage.layers:
            x = (checkpoint_replaying(lambda x_in, blk=blk: blk(x_in, positions), x, rng=None)
                 if remat else blk(x, positions))
        return x

    def _head(self, stage, x):
        return stage.lm_head(stage.final_norm(x))

    def params_from_jax(self, tree, stage_id):
        return pipe_params_from_jax(tree, stage_id, self.num_stages)

    def params_to_jax(self, stage_dicts):
        return pipe_params_to_jax(stage_dicts)
