"""Stage models for the pipeline engine (counterpart of
``deeperspeed_tpu/models/pipe_base.py``).

A stage model (``GPTNeoXPipe``, ``LlamaPipe``) describes a transformer cut
into ``num_stages`` equal stages of ``layers_per_stage`` blocks; the
pipeline engine asks it for one stage (:meth:`StagePipeBase.build_stage`),
the ``nn.Module`` the stage's process trains: the input embedding on the
first stage, the final norm and the output head on the last.

Its weights are the flat model's for the same seed: the stage replays the
whole model's draw, keeping only its own parameters (the others are drawn
into a scratch tensor and dropped), so a pipeline run and a flat run from
one seed start equal while a stage's process never holds more than its
stage and one other tensor.  The JAX package's parameters are ``{embed, stages, head}`` with
stage leaves ``[n_stages, layers_per_stage, ...]``; the pipeline
checkpoints hold that tree (:meth:`PipeStage.to_reference_tree` gathers it
over the ``pp`` group), and ``pipe_params_from_jax`` /
``pipe_params_to_jax`` of each family carry it to one stage's state dict
and back.

Under tensor parallelism (pp x tp) the engine splits a stage in place by
:meth:`PipeStage.param_partition_rules`, the flat model's rules on the
stage's own parameters: its blocks as the flat model's, the first stage's
embedding vocabulary-parallel (the JAX pipeline keeps that table whole; the
lookups are equal), the last stage's head column-parallel over the
vocabulary, whose loss is the vocabulary-parallel cross entropy.
"""

import re

import torch
from torch import nn

from .. import comm
from ..accelerator import resolve_device
from ..parallel.tensor_parallel import (ColumnParallelLinear, gather_from_tensor_parallel,
                                        vocab_parallel_log_likelihood)
from ..sequence import sequence_positions


def _masked_mean(token_ll, loss_mask):
    mask = torch.ones_like(token_ll) if loss_mask is None else loss_mask.to(token_ll.dtype)
    return -(token_ll * mask).sum() / mask.sum().clamp(min=1.0)


def loss_from_logits(logits, labels, loss_mask=None, split=None):
    """Masked mean next-token cross entropy over fp32 logits: logsumexp
    minus the gold logit (the JAX package's ``loss_from_logits``).  With
    ``split = (group, start)`` the logits are a tp rank's slice of the
    vocabulary, ``[start, start + V/tp)``, and the cross entropy is the
    vocabulary-parallel one (the JAX version's one-hot masked sum over a
    tp-sharded head: each slice adds its part, summed over ``tp``)."""
    logits = logits.to(torch.float32)
    if split is not None:
        return _masked_mean(vocab_parallel_log_likelihood(logits, labels.long(), *split),
                            loss_mask)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return _masked_mean(gold - lse, loss_mask)


class PipeStage(nn.Module):
    """One stage of a stage model: ``layers`` (its blocks) and, on the first
    stage, the family's embedding modules, on the last its head modules.
    The engine's contract: :meth:`stage_input`, :meth:`forward_stage`,
    :meth:`stage_loss`, :meth:`stage_output`."""

    def __init__(self, spec, stage_id, parts):
        super().__init__()
        self.spec = spec
        self.config = spec.config
        self.stage_id = stage_id
        self.num_stages = spec.num_stages
        self.is_first = stage_id == 0
        self.is_last = stage_id == spec.num_stages - 1
        # the sp group, where the engine runs the stage sequence-parallel
        self.sp_group = None
        for name, module in parts.items():
            setattr(self, name, module)

    # ------------------------------------------------------- the functions
    def embed(self, tokens):
        return self.spec._embed(self, tokens)

    def stage_forward(self, x, positions, rng=None):
        """This stage's ``layers_per_stage`` blocks on ``x`` [B, S, H]."""
        return self.spec._blocks(self, x, positions, rng)

    def head(self, x):
        return self.spec._head(self, x)

    loss_from_logits = staticmethod(loss_from_logits)

    # -------------------------------------------------- the engine's calls
    def stage_input(self, mb):
        return mb["input_ids"]

    def forward_stage(self, x, mb, rng=None):
        """The stage's output for the microbatch ``mb``: the first stage
        embeds ``x`` (its tokens) first; every stage runs its blocks."""
        if self.is_first:
            x = self.embed(x)
        B, S = x.shape[:2]
        return self.stage_forward(x, sequence_positions(self, B, S, x.device), rng)

    def _head_split(self):
        """(group, start) of the last stage's vocabulary-parallel head, or
        None where it is whole."""
        head = getattr(self, self.spec.HEAD[-1], None)
        if isinstance(head, ColumnParallelLinear):
            return head.group, head.out_start
        return None

    def stage_loss(self, y, mb):
        return self.loss_from_logits(self.head(y), mb["labels"], mb.get("loss_mask"),
                                     self._head_split())

    def stage_output(self, y):
        """The last stage's logits, whole (joined over ``tp``)."""
        logits, split = self.head(y), self._head_split()
        return logits if split is None else gather_from_tensor_parallel(logits, split[0])

    # ------------------------------------------------- tensor parallelism
    def param_partition_rules(self):
        """The flat model's tensor-parallel rules restricted to this
        stage's parameters: the engine's ``shard_module`` splits a stage's
        blocks, its embedding (vocabulary-parallel, stage 0) and its head
        (column-parallel over the vocabulary, the last stage) as it splits
        the flat model."""
        names = [n for n, _ in self.named_parameters()]
        return [rule for rule in self.spec.TP_RULES
                if any(re.search(rule[0], n) for n in names)]

    def check_tensor_parallel(self, tp):
        """The flat model's check that ``tp`` splits the heads whole
        (Llama's KV heads), on this stage's config."""
        check = getattr(self.spec.FLAT, "check_tensor_parallel", None)
        if check is not None:
            check(self, tp)

    # ------------------------------------------------------------- engine
    def replace_config(self, **changes):
        import dataclasses

        self.config = dataclasses.replace(self.config, **changes)
        for mod in self.modules():
            if hasattr(mod, "config"):
                mod.config = self.config
        return self

    def no_cast_paths(self):
        """The embedding tables stay fp32 under mixed precision (the JAX
        pipeline casts the stage and head parameters only)."""
        return self.spec.NO_CAST

    def to_reference_tree(self, flat):
        """The JAX package's ``{embed, stages, head}`` tree of ``flat`` (this
        stage's parameters, or a per-parameter optimizer tree): gathered
        from every stage over the ``pp`` group, a collective."""
        mine = {n: t.detach().to("cpu", torch.float32) for n, t in flat.items()}
        every = comm.all_gather_object(mine, comm.get_pipe_parallel_group()) \
            if self.num_stages > 1 else [mine]
        return self.spec.params_to_jax(every)

    def from_reference_tree(self, tree):
        """This stage's parameters from the JAX package's pipe tree."""
        return self.spec.params_from_jax(tree, self.stage_id)


class StagePipeBase:
    """A transformer cut into ``num_stages`` stages.  Subclasses set
    ``FLAT`` (the flat model's class), ``EMBED`` / ``HEAD`` (its module
    names on the first / last stage), ``NO_CAST`` and implement
    :meth:`_embed`, :meth:`_blocks`, :meth:`_head`, :meth:`params_from_jax`
    and :meth:`params_to_jax`.

    ``device`` (CUDA unless ``"cpu"``) and ``seed`` are the flat model's
    arguments: :meth:`build_stage` draws the flat model's weights of one
    stage."""

    FLAT = None
    EMBED = ()
    HEAD = ()
    NO_CAST = []
    TP_RULES = []

    def __init__(self, config, num_stages, device=None, seed=0):
        if config.num_layers % num_stages:
            raise ValueError(f"{config.num_layers} layers not divisible by "
                             f"{num_stages} stages")
        self.config = config
        self.num_stages = num_stages
        self.layers_per_stage = config.num_layers // num_stages
        self.device = device
        self.seed = seed

    def _draw_device(self, device):
        """Where the flat model draws its weights when it lives on
        ``device`` (the Llama family: there)."""
        return device

    def build_stage(self, stage_id, device=None):
        """Stage ``stage_id``'s module on ``device`` (the spec's device by
        default): the flat model built on ``meta``, this stage's modules
        made real where the flat model draws, and the flat model's draw
        replayed over them (``_init_weights``; the other stages' parameters
        stay on ``meta``)."""
        device = resolve_device(device if device is not None else self.device)
        flat = self.FLAT(self.config, device="meta")
        L = self.layers_per_stage
        parts = {}
        if stage_id == 0:
            parts.update((n, getattr(flat, n)) for n in self.EMBED if hasattr(flat, n))
        parts["layers"] = nn.ModuleList(flat.layers[stage_id * L:(stage_id + 1) * L])
        if stage_id == self.num_stages - 1:
            parts.update((n, getattr(flat, n)) for n in self.HEAD if hasattr(flat, n))
        draw = self._draw_device(device)
        for module in parts.values():
            module.to_empty(device=draw)
        flat._init_weights(torch.Generator(device=draw).manual_seed(self.seed))
        return PipeStage(self, stage_id, parts).to(device)

    def example_batch(self, batch_size=2, seq_len=None, seed=0):
        """The flat model's ``example_batch`` (int64 tokens on the CPU)."""
        return self.FLAT.example_batch(self, batch_size, seq_len, seed)

    loss_from_logits = staticmethod(loss_from_logits)

    def _embed(self, stage, tokens):
        raise NotImplementedError

    def _blocks(self, stage, x, positions, rng):
        raise NotImplementedError

    def _head(self, stage, x):
        raise NotImplementedError

    def params_from_jax(self, tree, stage_id):
        raise NotImplementedError

    def params_to_jax(self, stage_dicts):
        raise NotImplementedError
