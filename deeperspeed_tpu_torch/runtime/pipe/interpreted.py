"""Interpreted pipeline engine (counterpart of
``deeperspeed_tpu/runtime/pipe/interpreted.py``): a ``PipelineModule`` of
any ``LayerSpec`` graph, tied layers included, over per-stage processes.

Each process builds its own stage's layers (``PipelineModule.build_stage``)
and walks its instruction stream as :class:`PipelineEngine` does; the
first stage reads the batch's ``input_ids`` (else ``x``), the last stage's
``loss_fn(output, labels)`` reads ``labels`` (else ``y``; with other keys,
such as ``loss_mask``, the dict of every key but the input).

Tied layers (``TiedLayerSpec``): every stage holding a member keeps the
weights; the first of them owns them.  ``ReduceTiedGrads``: after each
stage's data-parallel reduction, the tie's gradients are summed over its
member stages (an all-reduce over the ranks of one replica that hold it);
after the update the owner's weights are broadcast back to the others.
The global norm counts the tie once, on its owner.

ZeRO 1-2 partition each stage's masters and optimizer state over its
data-parallel group; stage 3 is refused.  At ``tp`` > 1 the layers are not
split: each tp rank runs its stage whole on the same rows, as the JAX
engine does, so the losses are tp 1's; at ``sp`` > 1 likewise each sp rank
runs its rows' whole sequences (any layer graph: one without a sequence
dim too), and the losses are sp 1's, as the JAX engine's are.  ``eval_batch(...,
compute_loss=True, bcast_loss=True)`` and the curriculum's seqlen
truncation are :class:`PipelineEngine`'s.

Checkpoints hold the JAX engine's canonical trees: ``{"layers": {"layer_<i>":
...}, "tied": {key: ...}}`` by global layer index, each layer under its
flax names (a ``Linear``'s weight as a ``Dense`` kernel ``[in, out]``, an
``Embedding``'s as ``embedding``, a LayerNorm's as ``scale``), gathered
over the ``pp`` group; so a save at one ``pp`` x ``dp`` loads at any other,
in either package.  ``checkpoint.load_universal`` loads a universal export
(``checkpoint/universal.py`` ``load_universal_into_interpreted``).
"""

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ... import comm
from ...models.gpt_neox import ModelLayerNorm
from ...parallel import topology as topo
from ...utils.tree import tree_sorted
from .engine import PipelineEngine
from .module import PipelineModule


def _flax_leaf(module, leaf, value):
    """A torch parameter ``leaf`` of ``module`` under its flax name."""
    if isinstance(module, nn.Linear) and leaf == "weight":
        return "kernel", value.t()
    if isinstance(module, nn.Embedding) and leaf == "weight":
        return "embedding", value
    if isinstance(module, (nn.LayerNorm, ModelLayerNorm)) and leaf == "weight":
        return "scale", value
    return leaf, value


def _torch_leaf(module, key, value):
    """The inverse of :func:`_flax_leaf`."""
    if isinstance(module, nn.Linear) and key == "kernel":
        return "weight", value.t()
    if isinstance(module, nn.Embedding) and key == "embedding":
        return "weight", value
    if isinstance(module, (nn.LayerNorm, ModelLayerNorm)) and key == "scale":
        return "weight", value
    return key, value


class InterpretedStage(nn.Module):
    """One stage of a ``PipelineModule``: its layers' modules as
    ``layer_<i>`` (global index) and each tie's as ``tied_<key>``."""

    def __init__(self, pipe_module, stage_id, device):
        super().__init__()
        self.stage_id = stage_id
        self.num_stages = pipe_module.num_stages
        self.is_first = stage_id == 0
        self.is_last = stage_id == pipe_module.num_stages - 1
        self.layers_rt = pipe_module.build_stage(stage_id)
        self.loss = pipe_module.loss_fn
        self.owned_ties = {k for k in pipe_module.tied_specs
                           if pipe_module.tie_stages(k)[0] == stage_id}
        self.paths = {}             # submodule name -> the layer's canonical path
        for layer in self.layers_rt:
            name = (f"tied_{layer.tied_key}" if layer.tied_key is not None
                    else layer.name)
            if name not in self.paths:
                self.add_module(name, layer.module)
                self.paths[name] = (("tied", layer.tied_key) if layer.tied_key is not None
                                    else ("layers", layer.name))
        self.to(device)

    # -------------------------------------------------- the engine's calls
    @staticmethod
    def _input_key(mb):
        return "input_ids" if "input_ids" in mb else "x"

    def stage_input(self, mb):
        return mb[self._input_key(mb)]

    def forward_stage(self, x, mb, rng=None):
        for layer in self.layers_rt:
            x = layer(x)
        return x

    def stage_loss(self, y, mb):
        rest = {k: v for k, v in mb.items() if k != self._input_key(mb)}
        labels = (rest.get("labels", rest.get("y")) if set(rest) <= {"labels", "y"}
                  else rest)
        return torch.as_tensor(self.loss(y, labels), dtype=torch.float32)

    def stage_output(self, y):
        return y

    def param_partition_rules(self):
        """None: at ``tp`` > 1 a stage's layers run whole on every tp rank,
        replicated, as the JAX engine keeps them (its
        ``_init_params_and_ties`` shards them over the ZeRO axes only)."""
        return []

    # ---------------------------------------------------------- checkpoints
    def _local_tree(self, flat):
        """This stage's canonical subtree of ``flat`` (its layers and the
        ties it owns) under flax names, on the CPU."""
        tree = {"layers": {}, "tied": {}}
        for name, value in flat.items():
            top, _, rest = name.partition(".")
            kind, key = self.paths[top]
            if kind == "tied" and key not in self.owned_ties:
                continue
            *owner, leaf = rest.split(".")
            module = self.get_submodule(".".join([top] + owner))
            leaf, value = _flax_leaf(module, leaf, value.detach().to("cpu", torch.float32))
            node = tree[kind].setdefault(key, {})
            for k in owner:
                node = node.setdefault(k, {})
            node[leaf] = value
        return tree

    def to_reference_tree(self, flat):
        """The canonical ``{"layers", "tied"}`` tree of every stage's
        ``flat`` (a collective over the ``pp`` group)."""
        mine = self._local_tree(flat)
        every = comm.all_gather_object(mine, comm.get_pipe_parallel_group()) \
            if self.num_stages > 1 else [mine]
        out = {"layers": {}, "tied": {}}
        for tree in every:
            out["layers"].update(tree["layers"])
            out["tied"].update(tree["tied"])
        return tree_sorted(out)

    def from_reference_tree(self, tree):
        """This stage's parameters (tie replicas included) from a canonical
        tree."""
        flat = {}
        for top, (kind, key) in self.paths.items():
            if key not in tree.get(kind, {}):
                raise KeyError(f"checkpoint missing subtree {kind}/{key} required by "
                               f"the current module graph")

            def walk(node, path):
                for k, v in node.items():
                    if isinstance(v, dict):
                        walk(v, path + [k])
                        continue
                    module = self.get_submodule(".".join([top] + path))
                    leaf, value = _torch_leaf(module, k, torch.as_tensor(
                        np.asarray(v, np.float32)))
                    flat[".".join([top] + path + [leaf])] = value

            walk(tree[kind][key], [])
        return flat


class InterpretedPipelineEngine(PipelineEngine):
    """Trains a ``PipelineModule`` (any layer graph, ``TiedLayerSpec`` ties)
    over per-stage processes; its loss is the module's ``loss_fn``."""

    # the layers are any graph: at sp > 1 every sp rank runs its rows'
    # whole sequences, as at tp > 1 (the JAX engine computes sp 1's
    # function under GSPMD)
    _SEQ_SLICED = False

    def __init__(self, module, config, optimizer=None, lr_scheduler=None,
                 training_data=None, collate_fn=None, device=None):
        if not isinstance(module, PipelineModule):
            raise ValueError("InterpretedPipelineEngine needs a PipelineModule")
        if module.loss_fn is None:
            raise ValueError("the interpreted pipeline computes the loss on the last "
                             "stage: construct PipelineModule(..., loss_fn=...)")
        self._pipe_module = module
        super().__init__(module, config, optimizer=optimizer, lr_scheduler=lr_scheduler,
                         training_data=training_data, collate_fn=collate_fn, device=device)
        self._init_ties()

    def _stage_module(self, model, mesh, config, device):
        if mesh.pp != model.num_stages:
            raise ValueError(f"mesh pp={mesh.pp} != module stages={model.num_stages}")
        from ...accelerator import resolve_device

        return InterpretedStage(model, self.stage_id, resolve_device(device))

    def _init_ties(self):
        """Each tie spanning several stages: its group of ranks (this
        replica's member stages, the owner first) and this stage's
        parameters of it.  Every rank makes every group, in one order."""
        pm, mesh = self._pipe_module, topo.get_mesh()
        me = dist.get_rank() if dist.is_initialized() else 0
        self._ties = {}
        for key in sorted(pm.tied_specs):
            stages = pm.tie_stages(key)
            if len(stages) < 2:
                continue
            for pipe in mesh.groups((topo.PP_AXIS,)):
                ranks = [pipe[s] for s in stages]
                pg = dist.new_group(ranks) if len(ranks) < mesh.world else None
                if me in ranks:
                    group = comm.CommGroup((topo.PP_AXIS,), name=f"tie_{key}", pg=pg,
                                           ranks=ranks)
                    names = [n for n in self._order if n.startswith(f"tied_{key}.")]
                    self._ties[key] = (group, names, stages[0] == self.stage_id)

    # ------------------------------------------------------ the tie's steps
    def _reduce_gradients(self, divisor):
        """The data-parallel reduction, then ``ReduceTiedGrads``."""
        super()._reduce_gradients(divisor)
        with torch.no_grad():
            for group, names, _ in self._ties.values():
                whole = self.gather_whole(self.grads, names)
                flat = torch.cat([whole[n].reshape(-1) for n in names])
                comm.all_reduce(flat, group=group, log_name="tied_grads")
                self.load_whole(self._split(flat, whole, names), self.grads, strict=False)

    @staticmethod
    def _split(flat, like, names):
        out, off = {}, 0
        for n in names:
            k = like[n].numel()
            out[n] = flat[off:off + k].view(like[n].shape)
            off += k
        return out

    def _apply(self, lr):
        """The update, then the owner's tied weights sent to the other
        member stages."""
        super()._apply(lr)
        if not self._ties:
            return
        with torch.no_grad():
            for group, names, _ in self._ties.values():
                whole = self.gather_whole(self.master_params, names)
                flat = torch.cat([whole[n].reshape(-1) for n in names])
                comm.broadcast(flat, 0, group, log_name="tied_weights")
                self.load_whole(self._split(flat, whole, names), self.master_params,
                                strict=False)
            self._refresh_compute()

    def _replica_sq(self):
        held = [self.grads[n] for _, ns, owner in self._ties.values() if not owner
                for n in ns if n in self.grads]
        if not held:
            return None
        return torch.stack([g.to(torch.float32).square().sum() for g in held]).sum().reshape(1)
