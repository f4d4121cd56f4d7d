"""DeeperSpeedEngine: the training engine, on one process or several
(counterpart of ``deeperspeed_tpu/runtime/engine.py``).

The JAX engine compiles one train step: a ``scan`` over the gradient-
accumulation microbatches, the unscale / overflow check / global norm /
clip, the optimizer update of fp32 masters, the loss-scale update.  Here
the same step runs eagerly, in the same order and precision:

* fp32 masters and the optimizer state live in the engine, the masters in
  one flat buffer with a view per parameter;
* the module's parameters are the compute copy: under bf16/fp16 each one
  is a view into one flat buffer of the compute type, refreshed from the
  masters by one copy after each update; a parameter kept in fp32 (the
  input embedding, ``no_cast_paths``) and every parameter in fp32 training
  is the master view itself, updated in place;
* each microbatch's gradients are cast to the accumulation type
  (``data_types.grad_accum_dtype``, fp32 by default) and added into one
  flat buffer of that type; the sum is divided by the accumulation count
  in that type and lands in one flat fp32 buffer, so the norm, the clip,
  the overflow scan and the optimizer are one pass each;
* fp16 skips the update of a step whose gradients overflow and backs the
  loss scale off (``precision.py``).

Several processes (``torch.distributed``, one device each; the world is
the data-parallel axis): every rank takes its contiguous slice of each
global microbatch (``batch=`` and ``data_iter=`` carry global
microbatches; the engine's loader yields each rank its slice), and the
gradient is the mean over ranks, reduced in ``communication_data_type``
(else the accumulation type).  ZeRO (``zero/sharding.py``): at stage 0
every rank keeps everything and all-reduces the accumulated gradients once
a step; stages 1-3 keep only the rank's partition of the masters and the
optimizer state (the optimizer steps over the rank's *pieces* of the
parameters, views that keep each parameter's number of dimensions), and
all-gather the compute copy after the update; stage 1 reduce-scatters the
accumulated gradients once a step, stages 2-3 each microbatch's; stage 3
also partitions the compute parameters and gathers them at their module's
call (``zero/stage3.py``).  The global norm and the fp16 overflow flag are
taken across ranks, and the reported loss is the mean of the ranks'.
Where microbatches carry ``loss_mask``, each rank's masked mean is first
weighted by its share of the microbatch's mask over all ranks
(:meth:`_mask_weights`), so that the mean over ranks, of the losses and of
the gradients, is the global masked mean the JAX engine takes over the
dp-sharded rows (train, eval and the legacy API alike).  qgZ
(``comm.quantized`` or ``zero_quantized_gradients`` at stage 0) reduces
each parameter's mean gradient of at least ``group_size x world`` elements
through ``comm.all_reduce_quantized`` (B5 on the card), the smaller ones
exactly, as the JAX engine does.

Two ways to drive it share that code: ``train_batch`` (a whole step over
gas microbatches, from ``batch=``, ``data_iter=`` or, without arguments,
the loader built from ``training_data=``), and the legacy
``forward`` / ``backward`` / ``step`` (one microbatch at a time); both
accumulate through :meth:`_accumulate` and finish through
:meth:`_finish_step`, so they give the same bits.

Training draws its randomness (dropout, random-LTD) from one
``torch.Generator`` on the engine's device seeded from ``config.seed`` plus
the rank, so ranks draw different masks for their different rows;
evaluation draws none.  The data-efficiency stack (curriculum seqlen
truncation, progressive layer drop, random-LTD) runs on the host between
steps, as in the JAX engine.

The loss function is ``loss(model, batch, rng)`` (the model's
``loss_fn()``, or ``loss_fn=``): ``rng`` is the generator in training and
None in evaluation.

Checkpoints (``runtime/checkpointing.py``): :meth:`save_checkpoint` and
:meth:`load_checkpoint` write and read the JAX package's format (whole fp32
arrays under flax's names, the optax state as flax's dict of it), so either
package loads the other's; a save at any world size and ZeRO stage loads at
any other, each rank copying its own pieces in place
(:meth:`gather_whole`, :meth:`load_whole`).  ``checkpoint.load_universal``
loads a universal export (``checkpoint/universal.py``) instead.

Not ported yet (raising ``NotImplementedError``): the prefetching loader,
eigenvalue, compression, the step telemetry and the host-update
(optimizer offload) checkpoint branch; over several processes, progressive
layer drop (its draws must agree across ranks), LAMB at stage 1-3 (its
trust ratio needs whole parameters) and the chunked loss at stage 3 (it
reads the head's weight outside the head).
"""

import math
import re

import numpy as np
import torch

from .. import comm
from ..accelerator import resolve_device
from ..utils.logging import log_dist, logger
from ..utils.tree import tree_global_norm
from .config import COMM_DTYPES, PART2, DeeperSpeedConfig, _not_ported
from .lr_schedules import get_lr_schedule_fn
from .optimizers import build_optimizer, identity
from .precision import (
    MixedPrecisionPolicy,
    has_inf_or_nan,
    init_loss_scale,
    update_loss_scale,
)
from .zero import stage3
from .zero.quantized import fused_flat_reduce
from .zero.sharding import build_partition_plan, unit_of


class DeeperSpeedEngine:
    def __init__(self, model, config, optimizer=None, model_parameters=None,
                 loss_fn=None, training_data=None, collate_fn=None,
                 lr_scheduler=None, device=None):
        if not isinstance(config, DeeperSpeedConfig):
            config = DeeperSpeedConfig(config)
        self.config = config
        self.device = resolve_device(device)
        self.group = comm.get_data_parallel_group()
        self.world, self.rank = self.group.size(), self.group.rank()
        if config.world_size != self.world:
            raise ValueError(f"config built for {config.world_size} processes, "
                             f"the world has {self.world}")

        # ---- activation checkpointing: any requested option turns on
        # block-level recompute (JAX engine ``engine.py:127-145``)
        ac = config.activation_checkpointing
        if ((ac.partition_activations or ac.number_checkpoints
             or ac.cpu_checkpointing)
                and getattr(getattr(model, "config", None), "remat", None) is False):
            if ac.cpu_checkpointing:
                logger.warning("activation_checkpointing.cpu_checkpointing: "
                               "mapped to on-device rematerialization")
            model.replace_config(remat=True)
            log_dist("activation checkpointing: block remat enabled", ranks=[0])
        self._check_multi_process(model)

        self.precision = MixedPrecisionPolicy(config)
        self._init_qgz()
        # the type the data-parallel reduction runs in (the JAX engine's
        # ``reduce_dtype or accum_dtype``)
        self._comm_dtype = (COMM_DTYPES[config.communication_data_type]
                            or self._accum_dtype)
        if loss_fn is None:
            if not hasattr(model, "loss_fn"):
                raise ValueError("pass loss_fn= or use a model exposing .loss_fn()")
            loss_fn = model.loss_fn()
        self._loss_fn = loss_fn

        self.module = model.to(self.device)
        if model_parameters is not None:
            self.module.load_state_dict(model_parameters)
        self._build_state()

        # ---- optimizer: lr is applied by the engine unless a client
        # transformation folds it in ("updates are added", optax's convention)
        self._updates_include_lr = optimizer is not None
        base_lr = 0.0
        if optimizer is not None:
            self.tx = optimizer
        elif config.optimizer is not None:
            mup = (model.mup_multipliers() if hasattr(model, "mup_multipliers")
                   else None)
            self.tx = build_optimizer(config.optimizer.type,
                                      config.optimizer.params,
                                      mup_multipliers=mup)
            base_lr = config.optimizer.params.lr
        else:
            self.tx = identity()
        self.optimizer = self.tx
        self.opt_state = self.tx.init(self.master_params)

        # ---- lr schedule: a pure function of the optimizer step
        if lr_scheduler is not None and callable(lr_scheduler):
            self._lr_fn = lr_scheduler
        elif config.scheduler is not None:
            self._lr_fn = get_lr_schedule_fn(config.scheduler.type,
                                              config.scheduler.params,
                                              base_lr=base_lr)
        else:
            self._lr_fn = lambda step: base_lr
        self.lr_scheduler = self._lr_fn

        self.loss_scale_state = init_loss_scale(
            config.fp16 if self.precision.is_fp16 else None, self.device)
        # the training randomness: dropout, layer drop, token subsets
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(config.seed + self.rank)
        self.step_count = 0          # optimizer steps taken (skips excluded)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._last_metrics = {}
        self._acc_count = 0          # microbatches in the accumulation buffer
        self._reduced = False        # allreduce_gradients() ran for this step
        self._cached_loss = None

        # the data-efficiency schedulers precede the loader: deepspeed_io's
        # curriculum-sampling branch reads them
        self._init_data_efficiency()
        self.training_dataloader = None
        self._data_iterator = None
        if training_data is not None:
            from .dataloader import RepeatingLoader

            self.training_dataloader = self.deepspeed_io(training_data,
                                                         collate_fn=collate_fn)
            self._data_iterator = iter(RepeatingLoader(self.training_dataloader))

    # ------------------------------------------------------- process checks
    def _check_multi_process(self, model):
        """What the port refuses over several processes or at ZeRO stages,
        and stage 3's one change to the model (it recomputes each unit)."""
        cfg = self.config
        if self.world > 1 and cfg.progressive_layer_drop.enabled:
            raise _not_ported("progressive_layer_drop over several processes", PART2)
        if (cfg.zero_stage >= 1 and self.world > 1 and cfg.optimizer is not None
                and cfg.optimizer.type.lower() == "lamb"):
            raise _not_ported("LAMB at ZeRO stages 1-3 over several processes", PART2)
        mcfg = getattr(model, "config", None)
        if cfg.zero_stage == 3:
            if getattr(mcfg, "ce_chunk_tokens", 0) > 0:
                raise _not_ported("ce_chunk_tokens at ZeRO stage 3", PART2)
            if getattr(mcfg, "remat", False):
                # the stage-3 wrapper recomputes every unit (it gathers
                # inside the recompute), so block recompute would run twice
                model.replace_config(remat=False)

    def _init_qgz(self):
        """qgZ (the JAX engine's ``engine.py:322-362``): the quantized
        data-parallel reduction, at stage 0 only."""
        cfg = self.config
        cq = cfg.comm_quantized
        self._qgz = bool(cq.enabled)
        if cfg.zero_quantized_gradients and not self._qgz:
            if cfg.zero_stage == 0:
                self._qgz = True
            else:
                logger.warning("zero_quantized_gradients: the qgZ reduction requires "
                               "stage 0 (stage %d keeps the plain reduction); ignoring",
                               cfg.zero_stage)
        if self._qgz:
            if cq.enabled and cfg.zero_stage > 0:
                raise ValueError("comm.quantized requires zero stage 0: the qgZ "
                                 "reduction needs replicated masters")
            if self.precision.is_fp16:
                raise ValueError("comm.quantized supports fp32/bf16 only")
            if self.world == 1:
                logger.warning("comm.quantized: one process, nothing to quantize; "
                               "running plain reduction")
                self._qgz = False
        # the qgZ loop sums microbatch gradients in fp32, whatever
        # grad_accum_dtype says (JAX ``_grads_for_batch_qgz``)
        self._accum_dtype = torch.float32 if self._qgz else self.precision.accum_dtype

    # ------------------------------------------------------------------ state
    def _build_state(self):
        """The flat buffers of the partition plan (``zero/sharding.py``):
        masters and gradients hold this rank's partition of every region
        (the whole region at stage 0), the accumulation buffer whole local
        gradients (stages 0-1) or the partitions (stages 2-3), and the
        compute copy each region's whole buffer in its compute type (a
        partition of it for the regions stage 3 gathers).  Every rank starts
        from rank 0's weights."""
        named = dict(self.module.named_parameters())
        patterns = (self.module.no_cast_paths()
                    if hasattr(self.module, "no_cast_paths")
                    else [r"embed_in\.weight"])
        specs = {n: (tuple(p.shape), self.precision.compute_dtype(
            p, any(re.search(pat, n) for pat in patterns))) for n, p in named.items()}
        stage = self.config.zero_stage
        self.plan = plan = build_partition_plan(
            specs, stage, self.world, self.rank, self.config.param_persistence_threshold,
            {n: unit_of(n, self.module) for n in named} if stage == 3 else None)
        self._order = plan.order
        dev, f32, accum = self.device, torch.float32, self._accum_dtype
        local = plan.local_numel
        self._master_flat = torch.empty(local, dtype=f32, device=dev)
        self._grad_flat = torch.zeros(local, dtype=f32, device=dev)
        acc_numel = sum(r.padded for r in plan.regions) if stage == 1 else local
        self._acc_flat = (self._grad_flat if accum == f32 and acc_numel == local else
                          torch.zeros(acc_numel, dtype=accum, device=dev))
        self.master_params, self.grads = {}, {}
        self._params, self._acc_views = [], []   # whole-gradient accumulation
        self._scatter = []      # stages 2-3: (region, its parameters, acc partition)
        self._compute = []      # (region, master partition, compute buffer, gathered)
        self._gathered_acc = []  # stage 3: accumulation partitions the gathers feed
        units = {}
        acc_off = 0
        with torch.no_grad():
            for region, base in zip(plan.regions, plan.bases()):
                params = [named[n] for n in region.names]
                full = torch.zeros(region.padded, dtype=f32, device=dev)
                for p, off in zip(params, region.offsets):
                    full[off:off + p.numel()].copy_(p.detach().reshape(-1))
                if self.world > 1:
                    comm.broadcast(full, 0, self.group)
                i0 = plan.index * region.part
                master = self._master_flat[base:base + region.part]
                master.copy_(full[i0:i0 + region.part])
                for n, shape, a, b, at in region.pieces(plan.index):
                    keep = shape if b - a == named[n].numel() else \
                        (b - a,) + (1,) * (len(shape) - 1)
                    span = slice(base + at, base + at + b - a)
                    self.master_params[n] = self._master_flat[span].view(keep)
                    self.grads[n] = self._grad_flat[span].view(keep)
                acc = base if stage != 1 else acc_off
                acc_off += region.padded
                if stage <= 1:
                    for p, off in zip(params, region.offsets):
                        self._params.append(p)
                        self._acc_views.append(
                            self._acc_flat[acc + off:acc + off + p.numel()].view(p.shape))
                acc_part = self._acc_flat[base:base + region.part]
                if region.gathered:
                    shard = full[i0:i0 + region.part].to(region.dtype, copy=True)
                    shard.requires_grad_(True)
                    gathered = stage3.GatheredRegion(
                        region, shard, self.group, self._comm_dtype,
                        lambda part, acc=acc_part: acc.add_(part.to(acc.dtype)))
                    units.setdefault(region.unit, []).append(gathered)
                    self._gathered_acc.append(acc_part)
                    for p in params:
                        p.data = torch.empty(0, dtype=region.dtype, device=dev)
                    self._compute.append((region, master, None, gathered))
                    continue
                if stage >= 2:
                    self._params.extend(params)
                    self._scatter.append((region, params, acc_part))
                if stage == 0 and region.dtype == f32:
                    buf = None          # the parameters are the master views
                    for p, off in zip(params, region.offsets):
                        p.data = master[off:off + p.numel()].view(p.shape)
                else:
                    buf = full.to(region.dtype)
                    for p, off in zip(params, region.offsets):
                        p.data = buf[off:off + p.numel()].view(p.shape)
                self._compute.append((region, master, buf, None))
        for unit, gathered in units.items():
            stage3.install(self.module.get_submodule(unit) if unit else self.module,
                           unit + "." if unit else "", gathered)

    @torch.no_grad()
    def _refresh_compute(self):
        """The compute copy from the masters (the JAX engine's
        ``cast_for_compute``): one cast copy per region on one rank, an
        all-gather of the cast partitions over several, and at stage 3 the
        cast partition alone for the regions gathered at use."""
        for region, master, buf, gathered in self._compute:
            if gathered is not None:
                gathered.shard.copy_(master)
            elif buf is None:
                continue
            elif region.parts == 1:
                buf.copy_(master)
            else:
                comm.all_gather_into(buf, master.to(region.dtype), self.group)

    def full_master_params(self):
        """Every fp32 master whole, by name, a copy (gathered from the
        ranks' partitions at stages 1-3)."""
        return {n: t.clone() for n, t in self.gather_whole(self.master_params).items()}

    @torch.no_grad()
    def gather_whole(self, local):
        """Whole tensors by name from ``local``, a dict laid out like
        :attr:`master_params` (this rank's pieces: the masters or a
        per-parameter optimizer tree): views of ``local`` where a region is
        not partitioned, else gathered from the ranks' partitions (a
        collective every rank calls)."""
        out = {}
        for region, base in zip(self.plan.regions, self.plan.bases()):
            if region.parts == 1:
                out.update((n, local[n]) for n in region.names)
                continue
            part = torch.zeros(region.part, dtype=torch.float32, device=self.device)
            for n, _, a, b, at in region.pieces(self.plan.index):
                part[at:at + b - a].copy_(local[n].reshape(-1))
            full = comm.all_gather_into(
                torch.empty(region.padded, dtype=torch.float32, device=self.device),
                part, self.group)
            for n, shape, off in zip(region.names, region.shapes, region.offsets):
                out[n] = full[off:off + math.prod(shape)].view(shape)
        return out

    @torch.no_grad()
    def load_whole(self, whole, local, strict=True):
        """Copy this rank's pieces of ``whole`` (name -> whole tensor, on any
        device) into ``local`` (laid out like :attr:`master_params`), in
        place: the tensors of ``local`` are never rebound.  ``strict``:
        ``whole`` must name every parameter and nothing else."""
        missing = [n for n in self._order if n not in whole]
        extra = sorted(set(whole) - set(self._order))
        if strict and (missing or extra):
            raise KeyError(f"checkpoint parameters differ from the model's: missing "
                           f"{missing[:5]}, unexpected {extra[:5]}")
        for region in self.plan.regions:
            for n, shape, a, b, _ in region.pieces(self.plan.index):
                if n not in whole:
                    continue
                src = whole[n]
                if tuple(src.shape) != tuple(shape):
                    raise ValueError(f"checkpoint {n}: shape {tuple(src.shape)}, "
                                     f"the model's {tuple(shape)}")
                local[n].view(-1).copy_(src.reshape(-1)[a:b])

    # ------------------------------------------------------------------ data
    def _to_device(self, mb):
        return {k: torch.as_tensor(v).to(self.device) for k, v in mb.items()}

    def _local(self, mb):
        """This rank's contiguous slice of the rows of a global microbatch
        (the rows the JAX batch sharding over dp gives it)."""
        if self.world == 1:
            return mb
        rows = {len(v) for v in mb.values()}
        if len(rows) != 1 or next(iter(rows)) % self.world:
            raise ValueError(f"microbatch rows {sorted(rows)} not divisible by "
                             f"{self.world} processes")
        per = next(iter(rows)) // self.world
        return {k: v[self.rank * per:(self.rank + 1) * per] for k, v in mb.items()}

    def _stack_microbatches(self, data, local=False):
        """gas microbatch dicts from a full batch dict (split along rows), a
        list/tuple of gas microbatches, or an iterator yielding them; each
        a global microbatch, of which this rank keeps its rows (``local``:
        already this rank's, as the engine's loader yields them)."""
        gas = self.gradient_accumulation_steps()
        if isinstance(data, (list, tuple)):
            micro = list(data)
            if len(micro) != gas:
                raise ValueError(f"need {gas} microbatches, got {len(micro)}")
        elif hasattr(data, "__next__"):
            micro = [next(data) for _ in range(gas)]
        else:
            rows = {len(v) for v in data.values()}
            if len(rows) != 1 or next(iter(rows)) % gas:
                raise ValueError(f"batch rows {sorted(rows)} not divisible by "
                                 f"gas={gas}")
            mb = next(iter(rows)) // gas
            micro = [{k: v[i * mb:(i + 1) * mb] for k, v in data.items()}
                     for i in range(gas)]
        return [self._to_device(m if local else self._local(m)) for m in micro]

    def deepspeed_io(self, dataset, batch_size=None, data_sampler=None, collate_fn=None):
        """The engine's loader over ``dataset``: global microbatches of
        ``train_micro_batch_size_per_gpu`` x world rows, shuffled from
        ``config.seed``, of which it yields this rank's slice; with
        ``data_efficiency.data_sampling`` enabled, drawn by the curriculum
        sampler from a metric-sorted order (JAX engine ``deepspeed_io``)."""
        from .dataloader import DeeperSpeedDataLoader

        bs = batch_size or self.train_micro_batch_size_per_gpu() * self.world
        de = self.config.data_efficiency
        ds_cfg = dict(de.data_sampling)
        if data_sampler is None and de.enabled and ds_cfg.get("enabled"):
            from .data_pipeline.data_sampling.data_sampler import (
                DeeperSpeedDataSampler)

            path = ds_cfg.get("sorted_index_path")
            data_sampler = DeeperSpeedDataSampler(
                n_samples=(len(next(iter(dataset.values())))
                           if isinstance(dataset, dict) else len(dataset)),
                batch_size=bs,
                curriculum_scheduler=self.curriculum_scheduler,
                sorted_index=np.load(path) if path else None,
                seed=ds_cfg.get("seed", de.seed),
                # the loader is drawn gas times per optimizer step
                draws_per_step=self.gradient_accumulation_steps(),
            )
        return DeeperSpeedDataLoader(dataset, batch_size=bs, collate_fn=collate_fn,
                                     drop_last=True, seed=self.config.seed,
                                     sampler=data_sampler, num_shards=self.world,
                                     shard_index=self.rank)

    # ------------------------------------------------- data-efficiency stack
    def _init_data_efficiency(self):
        """The config-gated schedulers (JAX engine ``_init_data_efficiency``):
        each runs on the host between steps."""
        cfg = self.config
        self.curriculum_scheduler = None
        if cfg.curriculum.enabled:
            from .data_pipeline.curriculum_scheduler import CurriculumScheduler

            self.curriculum_scheduler = CurriculumScheduler(cfg.curriculum.params)
        self.progressive_layer_drop = None
        if cfg.progressive_layer_drop.enabled:
            from .progressive_layer_drop import ProgressiveLayerDrop

            self.progressive_layer_drop = ProgressiveLayerDrop(
                theta=cfg.progressive_layer_drop.theta,
                gamma=cfg.progressive_layer_drop.gamma)
        self.random_ltd_scheduler = None
        de = cfg.data_efficiency
        routing = dict(de.data_routing.get("random_ltd", {})) if de.enabled else {}
        if routing.get("enabled"):
            from .data_pipeline.data_routing.scheduler import RandomLTDScheduler

            sched = dict(routing.get("random_ltd_schedule", {}))
            steps = sched.get("schedule_config", {})
            self.random_ltd_scheduler = RandomLTDScheduler(
                min_tokens=sched.get("min_value", 128),
                max_tokens=sched.get("max_value", 2048),
                total_steps=steps.get("require_steps", sched.get("total_steps", 10000)),
                step_size=steps.get("seq_per_step", sched.get("step_size", 16)))

    def _apply_data_efficiency(self, micro):
        """Per-step injection: truncate to the curriculum seqlen, add the PLD
        theta to each microbatch, and return the current LTD token budget."""
        step = self.global_steps + 1
        if (self.curriculum_scheduler is not None
                and self.curriculum_scheduler.config.curriculum_type == "seqlen"):
            seqlen = self.curriculum_scheduler.update_difficulty(step)
            micro = [{k: v[:, :seqlen] if v.dim() >= 2 and v.shape[1] > seqlen else v
                      for k, v in mb.items()} for mb in micro]
        if self.progressive_layer_drop is not None:
            theta = self.progressive_layer_drop.update_state(step)
            micro = [{**mb, "pld_theta": theta} for mb in micro]
        ltd = None
        if self.random_ltd_scheduler is not None:
            ltd = int(self.random_ltd_scheduler.update(step))
        return micro, ltd

    # ------------------------------------------------------------- the step
    def _accumulate(self, loss, scale):
        """Backward of one microbatch's ``loss`` (times ``scale`` under fp16)
        and its gradients, cast to the accumulation type, added into the
        accumulation buffer: whole at stages 0-1; at stages 2-3 this rank's
        partition of their sum over ranks (stage 3's gathered regions get
        theirs from the gather's backward)."""
        if self._acc_count == 0:
            for acc in self._gathered_acc:
                acc.zero_()
        (loss if scale is None else loss * scale).to(torch.float32).backward()
        if self._scatter:
            self._scatter_micro()
        else:
            accum = self._accum_dtype
            views, grads, missing = [], [], []
            for p, v in zip(self._params, self._acc_views):
                if p.grad is None:          # a block PLD or random-LTD skipped
                    missing.append(v)
                else:
                    views.append(v)
                    grads.append(p.grad if accum == torch.float32 else p.grad.to(accum))
            if self._acc_count == 0:
                if missing:
                    torch._foreach_zero_(missing)
                if views:
                    torch._foreach_copy_(views, grads)
            elif views:
                torch._foreach_add_(views, grads)
        self._acc_count += 1
        for p in self._params:
            p.grad = None

    def _scatter_micro(self):
        """Stages 2-3: each region's microbatch gradients, in the
        communication type, reduce-scattered into this rank's partition
        (the sum over ranks) and added to its accumulation."""
        for region, params, acc_part in self._scatter:
            buf = torch.zeros(region.padded, dtype=self._comm_dtype, device=self.device)
            for p, off in zip(params, region.offsets):
                if p.grad is not None:      # a block PLD or random-LTD skipped
                    buf[off:off + p.numel()].copy_(p.grad.reshape(-1))
            part = comm.reduce_scatter(buf, self.group)
            if self._acc_count == 0:
                acc_part.copy_(part)
            else:
                acc_part.add_(part.to(acc_part.dtype))

    def _mask_weights(self, micro):
        """Per microbatch, this rank's weight ``world * count_r / max(count,
        1)``: ``count_r`` the sum of the rank's ``loss_mask``, ``count`` its
        sum over ranks, all microbatches' counts in one all-reduce.  None on
        one process, under qgZ (the JAX qgZ path takes per-rank means, too)
        and without a mask, where nothing changes."""
        if self.world == 1 or self._qgz or not all("loss_mask" in mb for mb in micro):
            return None
        counts = torch.stack([mb["loss_mask"].to(torch.float32).sum() for mb in micro])
        total = comm.all_reduce(counts.clone(), group=self.group)
        return self.world * counts / total.clamp(min=1.0)

    def _micro_loss(self, mb, ltd=None):
        for p in self._params:
            p.grad = None
        if ltd is None:
            return self._loss_fn(self.module, mb, self._rng)
        return self._loss_fn(self.module, mb, self._rng, random_ltd_tokens=ltd)

    def _scale(self):
        return self.loss_scale_state.scale if self.precision.is_fp16 else None

    def _finish_step(self, divisor):
        """Mean gradients (the accumulated sum over ``divisor`` microbatches
        and the ranks, in the accumulation type), unscale, overflow check,
        global norm, clip, update and loss-scale update: the JAX engine's
        train step after its microbatch scan, and its ``_make_apply``."""
        g = self._grad_flat
        with torch.no_grad():
            if not self._reduced:
                self._reduce_gradients(divisor)
            fp16 = self.precision.is_fp16
            if fp16:
                g.mul_(1.0 / self.loss_scale_state.scale)
            overflow = self._any_rank(has_inf_or_nan([g])) if fp16 else None
            grad_norm = self._global_norm(g)
            clip = self.config.gradient_clipping
            if clip > 0:
                g.mul_(torch.clamp(clip / (grad_norm + 1e-6), max=1.0))

            lr = float(self._lr_fn(self.step_count))
            skipped = fp16 and bool(overflow)    # the one host sync, fp16 only
            if not skipped:
                self._apply(lr)
                self.step_count += 1
            if fp16:
                self.loss_scale_state = update_loss_scale(
                    self.loss_scale_state, overflow, self.config.fp16)
        self._acc_count = 0
        self._reduced = False
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self.skipped_steps += int(skipped)
        return {"grad_norm": grad_norm, "lr": lr, "overflow": skipped,
                "loss_scale": self.loss_scale_state.scale}

    def _reduce_gradients(self, divisor):
        """The mean gradient over ``divisor`` microbatches and the ranks,
        into the fp32 gradient buffer (this rank's partitions at stages
        1-3)."""
        acc, g, n = self._acc_flat, self._grad_flat, self.world
        if self._qgz:
            self._reduce_qgz(divisor)
        elif self.plan.stage == 1:
            off = 0
            for region, base in zip(self.plan.regions, self.plan.bases()):
                whole = acc[off:off + region.padded].to(self._comm_dtype)
                off += region.padded
                part = comm.reduce_scatter(whole, self.group).to(acc.dtype)
                g[base:base + region.part].copy_(part.div_(divisor * n))
        else:
            if self.plan.stage == 0 and n > 1:
                if acc.dtype == self._comm_dtype:
                    comm.all_reduce(acc, group=self.group)
                else:
                    acc.copy_(comm.all_reduce(acc.to(self._comm_dtype), group=self.group))
            acc.div_(divisor * n)
            if acc is not g:
                g.copy_(acc)

    def _reduce_qgz(self, divisor):
        """qgZ (JAX ``_grads_for_batch_qgz``): each parameter's mean over
        microbatches, then its mean over ranks, through the quantized
        all-reduce for parameters of at least ``group_size x world``
        elements and one exact all-reduce for the smaller ones together."""
        cq = self.config.comm_quantized
        acc = self._acc_flat                 # fp32, the gradient buffer itself
        acc.div_(divisor)
        small = [v for v in self._acc_views if v.numel() < cq.group_size * self.world]
        large = [v for v in self._acc_views if v.numel() >= cq.group_size * self.world]
        if small:
            for v, r in zip(small, fused_flat_reduce(
                    small, lambda t: comm.all_reduce(t, comm.ReduceOp.AVG, self.group))):
                v.copy_(r)
        for v in large:
            v.copy_(comm.all_reduce_quantized(
                v, op=comm.ReduceOp.AVG, group=self.group, group_size=cq.group_size,
                impl=cq.impl, wire_dtype=cq.wire_dtype))

    def _partitioned(self):
        return self.plan.stage >= 1 and self.world > 1

    def _global_norm(self, g):
        """The L2 norm of the whole gradient: of the local buffer where it
        is whole, else the root of the ranks' summed squares."""
        if not self._partitioned():
            return tree_global_norm([g])
        sq = torch.dot(g, g).reshape(1)
        return torch.sqrt(comm.all_reduce(sq, group=self.group))[0]

    def _any_rank(self, flag):
        """A bool scalar, true if it is on any rank holding a partition."""
        if not self._partitioned():
            return flag
        return comm.all_reduce(flag.to(torch.float32).reshape(1), comm.ReduceOp.MAX,
                               self.group)[0] > 0

    @torch.no_grad()
    def _apply(self, lr):
        updates, self.opt_state = self.tx.update(dict(self.grads), self.opt_state,
                                                 self.master_params)
        masters = list(self.master_params.values())
        ups = [updates[n] for n in self.master_params]
        torch._foreach_add_(masters, ups, alpha=1.0 if self._updates_include_lr else -lr)
        self._refresh_compute()

    def _report(self, metrics):
        self._last_metrics = metrics
        if self.global_steps % self.config.steps_per_print == 0:
            loss = metrics.get("loss")
            log_dist(f"step {self.global_steps}: loss "
                     f"{float('nan') if loss is None else float(loss):.4f} "
                     f"lr {metrics['lr']:.3e} grad_norm "
                     f"{float(metrics['grad_norm']):.4f}", ranks=[0])

    def train_batch(self, data_iter=None, batch=None):
        """One full training step over gas microbatches; returns the mean
        loss as a device scalar (no host sync).  Without arguments the
        microbatches come from the loader over ``training_data=``."""
        if data_iter is None and batch is None:
            if self._data_iterator is None:
                raise ValueError("no data: pass data_iter/batch or training_data")
            data_iter = self._data_iterator   # persistent: keeps advancing epochs
        local = data_iter is self._data_iterator and data_iter is not None
        data = batch if batch is not None else data_iter
        micro, ltd = self._apply_data_efficiency(self._stack_microbatches(data, local))
        scale = self._scale()
        self._acc_count = 0
        weights = self._mask_weights(micro)
        losses = []
        for i, mb in enumerate(micro):
            loss = self._micro_loss(mb, ltd)
            if weights is not None:
                loss = loss * weights[i]
            self._accumulate(loss, scale)
            losses.append(loss.detach().to(torch.float32))
        loss = torch.stack(losses).mean()
        if self.world > 1:
            comm.all_reduce(loss.reshape(1), comm.ReduceOp.AVG, self.group)
        self.micro_steps += len(micro)
        metrics = self._finish_step(len(micro))
        self._report({"loss": loss, **metrics})
        return loss

    @torch.no_grad()
    def eval_batch(self, data_iter=None, batch=None):
        """Mean loss over gas microbatches, deterministic (no dropout), no
        gradients."""
        data = batch if batch is not None else data_iter
        micro = self._stack_microbatches(data)
        losses = torch.stack([self._loss_fn(self.module, mb, None).to(torch.float32)
                              for mb in micro])
        weights = self._mask_weights(micro)
        loss = (losses if weights is None else losses * weights).mean()
        if self.world > 1:
            comm.all_reduce(loss.reshape(1), comm.ReduceOp.AVG, self.group)
        return loss

    # -- legacy fwd/bwd/step API (reference ``engine.py:1775,1916,2114``)
    def forward(self, batch):
        """The loss of one (global) microbatch's rows on this rank, its
        graph kept for :meth:`backward`; with a ``loss_mask`` over several
        processes, weighted as :meth:`_mask_weights` says (its mean over
        ranks is the global masked mean)."""
        mb = self._to_device(self._local(batch))
        loss = self._micro_loss(mb)
        weights = self._mask_weights([mb])
        self._cached_loss = loss if weights is None else loss * weights[0]
        return self._cached_loss

    __call__ = forward

    def backward(self, loss=None, allreduce_gradients=True, release_loss=False):
        """Backward of the last :meth:`forward`'s loss; its gradients are
        added into the accumulation buffer."""
        loss = self._cached_loss if loss is None else loss
        if loss is None:
            raise RuntimeError("call forward() first")
        self._accumulate(loss, self._scale())
        self._cached_loss = None
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps % self.gradient_accumulation_steps()) == 0

    def step(self):
        """Apply the accumulated gradients: their sum over gas microbatches
        divided by gas, as the JAX engine's ``step`` divides."""
        if self._acc_count == 0:
            raise RuntimeError("no accumulated gradients: call forward() and "
                               "backward() first")
        metrics = self._finish_step(self.gradient_accumulation_steps())
        self._report({**self._last_metrics, **metrics})

    def zero_grad(self):
        """Drop the accumulated gradients."""
        self._acc_count = 0
        self._reduced = False

    def allreduce_gradients(self, bucket_size=None):
        """Reduce the accumulated gradients now (their mean over gas
        microbatches and the ranks), rather than in :meth:`step`; at stages
        2-3 only the last division is left by then.  Without accumulated
        gradients there is nothing to reduce."""
        if self._acc_count == 0 or self._reduced:
            return
        with torch.no_grad():
            self._reduce_gradients(self.gradient_accumulation_steps())
        self._reduced = True

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        exclude_frozen_parameters=False):
        """Save between steps (every rank calls it; rank 0 writes); the tag
        defaults to ``global_step{global_steps}``.  Returns the tag's
        directory."""
        from .checkpointing import save_checkpoint

        return save_checkpoint(self, save_dir, tag=tag, client_state=client_state or {},
                               save_latest=save_latest)

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True, load_lr_scheduler_states=True,
                        load_module_only=False, custom_load_fn=None):
        """Load the newest valid tag (or ``tag``) of ``load_dir``, written by
        either package; returns ``(ckpt_dir, client_state)``, ``(None, {})``
        when there is none.  With ``checkpoint.load_universal`` the
        directory is a universal export.  The lr schedule is a function of
        the restored step, so ``load_lr_scheduler_states`` has nothing more
        to load."""
        if self.config.checkpoint_config.load_universal:
            from ..checkpoint.universal import load_universal_into_engine

            if tag is not None:
                logger.warning("load_universal: universal exports are untagged; "
                               f"ignoring tag={tag}")
            meta = load_universal_into_engine(
                self, load_dir,
                load_optimizer_states=load_optimizer_states and not load_module_only)
            return load_dir, meta.get("client_state", {})
        from .checkpointing import load_checkpoint

        return load_checkpoint(self, load_dir, tag=tag,
                               load_optimizer_states=load_optimizer_states,
                               load_module_only=load_module_only,
                               load_module_strict=load_module_strict)

    # ------------------------------------------------------------ properties
    def train_batch_size(self):
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self.config.zero_stage

    def zero_optimization(self):
        return self.config.zero_stage > 0

    def fp16_enabled(self):
        return self.precision.is_fp16

    def bfloat16_enabled(self):
        return self.precision.is_bf16

    def get_lr(self):
        return [float(self._lr_fn(self.step_count))]

    def get_loss_scale(self):
        return float(self.loss_scale_state.scale)

    @property
    def loss_scale(self):
        return self.get_loss_scale()

    def get_global_grad_norm(self):
        gn = self._last_metrics.get("grad_norm")
        return float(gn) if gn is not None else None

    def get_params(self):
        """The compute-dtype parameters (the module's own), by name."""
        return {n: p.detach() for n, p in self.module.named_parameters()}
