"""Pipeline model specification (counterpart of
``deeperspeed_tpu/runtime/pipe/module.py``).

A model given as a flat list of layer specs, cut into contiguous stages.
Each stage's process builds only its own stage's specs
(:meth:`PipelineModule.build_stage`); a layer is a ``torch.nn.Module``
called on the previous layer's output.

Partition methods (the JAX package's ``_partition_layers``): ``uniform``
(equal layer counts), ``parameters`` (equal parameter counts, each spec's
module built on the ``meta`` device to count them), ``type:regex`` (equal
counts of layers whose class name matches the regex).
"""

import re

import numpy as np
import torch
from torch import nn

from ...utils.logging import logger


class LayerSpec:
    """Deferred layer constructor: ``typename(*module_args, **module_kwargs)``
    built by the stage that owns it."""

    def __init__(self, typename, *module_args, **module_kwargs):
        if not isinstance(typename, type):
            raise RuntimeError("LayerSpec only supports classes")
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs

    def build(self, log=False):
        if log:
            logger.info(f"building {repr(self)}")
        return self.typename(*self.module_args, **self.module_kwargs)

    def __repr__(self):
        args = ", ".join([repr(a) for a in self.module_args]
                         + [f"{k}={v!r}" for k, v in self.module_kwargs.items()])
        return f"LayerSpec({self.typename.__name__}, {args})"


class TiedLayerSpec(LayerSpec):
    """A layer whose parameters every spec of the same ``key`` shares.  Each
    stage holding a member builds the module once; across stages the first
    member's stage owns the weights and the others keep a copy, their
    gradients summed over the member stages before the update and the
    updated weights sent back after it (``ReduceTiedGrads``).
    ``forward_fn(module, x)`` replaces the module's call at this use (an
    embedding table used as the output head)."""

    def __init__(self, key, typename, *module_args, forward_fn=None,
                 tied_weight_attr="embedding", **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


def partition_uniform(num_items, num_parts):
    """Balanced contiguous split: stage boundary indices [p0 .. pN]."""
    parts = [0] * (num_parts + 1)
    chunk = num_items // num_parts
    residual = num_items % num_parts
    for p in range(num_parts):
        parts[p + 1] = parts[p] + chunk + (1 if p < residual else 0)
    return parts


def partition_balanced(weights, num_parts):
    """Split ``weights`` into contiguous chunks minimizing the heaviest
    chunk: binary search over the bottleneck, then greedy packing (the JAX
    package's, left-packed)."""
    weights = [int(w) for w in weights]
    n = len(weights)
    if num_parts >= n:
        return partition_uniform(n, num_parts)
    prefix = np.concatenate([[0], np.cumsum(weights)])

    def can_pack(limit):
        parts, start = 1, 0
        for i in range(1, n + 1):
            if prefix[i] - prefix[start] > limit:
                parts += 1
                start = i - 1
                if weights[i - 1] > limit or parts > num_parts:
                    return False
        return True

    lo, hi = max(weights), int(prefix[-1])
    while lo < hi:
        mid = (lo + hi) // 2
        if can_pack(mid):
            hi = mid
        else:
            lo = mid + 1
    bounds = [0]
    start = 0
    for i in range(1, n + 1):
        if prefix[i] - prefix[start] > lo:
            bounds.append(i - 1)
            start = i - 1
    while len(bounds) < num_parts:
        bounds.append(n)
    bounds.append(n)
    return bounds[: num_parts + 1]


class StageLayer:
    """One built layer of a stage: its global ``index``, the module, the
    tie key (None when untied) and the tie's ``forward_fn``."""

    def __init__(self, index, module, tied_key=None, forward_fn=None):
        self.index = index
        self.module = module
        self.tied_key = tied_key
        self.forward_fn = forward_fn
        self.name = f"layer_{index}"

    def __call__(self, x):
        if self.forward_fn is not None:
            return self.forward_fn(self.module, x)
        return self.module(x)


class PipelineModule:
    """Layer specs cut into ``num_stages`` stages; ``loss_fn(output,
    labels)`` runs on the last stage.  ``example_input()`` (on the module
    or the first spec's class) is not needed: each layer builds its own
    parameters."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seed_layers=False, partition_method="parameters",
                 activation_checkpoint_interval=0, checkpointable_layers=None,
                 base_seed=1234):
        self.specs = list(layers)
        self.loss_fn = loss_fn
        self.partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.checkpointable_layers = checkpointable_layers
        self.seed_layers = seed_layers
        self.base_seed = base_seed
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self.num_stages = num_stages or 1
        self.topology = topology
        self.parts = self._partition_layers()
        self.tied_specs = self._index_tied_modules()

    def _count_layer_params(self):
        """Each spec's parameter count, its module built on ``meta``."""
        counts = []
        for spec in self.specs:
            n = 0
            if isinstance(spec, LayerSpec):
                with torch.device("meta"):
                    module = spec.build()
                n = sum(p.numel() for p in module.parameters())
            elif isinstance(spec, nn.Module):
                n = sum(p.numel() for p in spec.parameters())
            counts.append(max(n, 1))
        return counts

    def _partition_layers(self):
        method = self.partition_method.lower()
        n = len(self.specs)
        if method == "uniform":
            parts = partition_uniform(n, self.num_stages)
        elif method == "parameters":
            parts = partition_balanced(self._count_layer_params(), self.num_stages)
        elif method.startswith("type:"):
            pattern = method.split(":", 1)[1]
            weights = [1 if re.search(pattern, _spec_class_name(s), re.IGNORECASE) else 0
                       for s in self.specs]
            if sum(weights) == 0:
                raise ValueError(f"no layers matched type regex {pattern!r}")
            parts = partition_balanced(weights, self.num_stages)
        else:
            raise NotImplementedError(
                f"partition method {self.partition_method} not supported")
        for p in range(self.num_stages):
            logger.debug(f"stage {p}: layers [{parts[p]}, {parts[p + 1]})")
        return parts

    def stage_layers(self, stage_id):
        lo, hi = self.parts[stage_id], self.parts[stage_id + 1]
        return self.specs[lo:hi]

    def stage_owner(self, layer_idx):
        for stage in range(self.num_stages):
            if self.parts[stage] <= layer_idx < self.parts[stage + 1]:
                return stage
        raise ValueError(f"layer {layer_idx} out of range")

    def _index_tied_modules(self):
        tied = {}
        for i, spec in enumerate(self.specs):
            if isinstance(spec, TiedLayerSpec):
                tied.setdefault(spec.key, []).append(i)
        return tied

    def tie_stages(self, key):
        """The stages holding a member of tie ``key``, the owner first."""
        return sorted({self.stage_owner(i) for i in self.tied_specs[key]})

    def build_stage(self, stage_id, seed=None):
        """Stage ``stage_id``'s layers (:class:`StageLayer`), built in order.
        Each layer's weights are drawn with the torch generator seeded from
        ``seed`` (``base_seed`` by default) plus its global index (a tie's
        from its first member's index), so every stage, at any number of
        stages, draws the same weights for a layer."""
        seed = self.base_seed if seed is None else seed
        tied, out = {}, []
        lo = self.parts[stage_id]
        for i, spec in enumerate(self.stage_layers(stage_id)):
            index = lo + i
            key = spec.key if isinstance(spec, TiedLayerSpec) else None
            if key is not None and key in tied:
                module = tied[key]
            elif isinstance(spec, LayerSpec):
                first = self.tied_specs[key][0] if key is not None else index
                with torch.random.fork_rng(devices=[]):
                    torch.manual_seed(seed + first)
                    module = spec.build()
                if key is not None:
                    tied[key] = module
            else:
                module = spec
            out.append(StageLayer(index, module, key,
                                  getattr(spec, "forward_fn", None)))
        return out

    def num_layers(self):
        return len(self.specs)

    def __len__(self):
        return len(self.specs)


def _spec_class_name(spec):
    if isinstance(spec, LayerSpec):
        return spec.typename.__name__
    return type(spec).__name__
