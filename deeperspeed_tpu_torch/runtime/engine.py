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

Several processes (``torch.distributed``, one device each, laid out by
the mesh, ``parallel/topology.py``): the ZeRO group is the ``dp x zshard
x ep x sp`` ranks of this rank's tensor-parallel slice (:attr:`group`, :attr:`world`,
:attr:`rank`, the data-parallel index); every rank takes the contiguous
slice of each global microbatch's rows its index in the batch group
(:attr:`batch_group`, the ZeRO group less ``sp``) names (``batch=`` and
``data_iter=`` carry global microbatches; the engine's loader yields each
rank its rows), and at ``sp`` > 1 the slice of the sequence its ``sp``
index names (:meth:`_seq_local`; the model is bound to the ``sp`` group,
``sequence/``, and holds those tokens at their global positions), so the
``tp`` ranks of one slice see the same tokens,
and the gradient is the mean over the ZeRO group, reduced in
``communication_data_type`` (else the accumulation type).  ZeRO
(``zero/sharding.py``): at stage 0 every rank keeps everything and
all-reduces the accumulated gradients once a step; stages 1-3 keep only
the rank's partition of the masters and the
optimizer state (the optimizer steps over the rank's *pieces* of the
parameters, views that keep each parameter's number of dimensions), and
all-gather the compute copy after the update; stage 1 reduce-scatters the
accumulated gradients once a step, stages 2-3 each microbatch's; stage 3
also partitions the compute parameters and gathers them at their module's
call (``zero/stage3.py``; through int8 under qwZ,
``zero_quantized_weights``).  The global norm and the fp16 overflow flag
are taken across ranks, and the reported loss is the mean of the ranks'.

MiCS (``mics_shard_size`` > 1): every partition is cut over the ``zshard``
group and replicated across ``dp``; a reduction is a reduce-scatter over
``zshard`` then an all-reduce over ``dp``.  hpZ (``zero_hpz_partition_size``
> 1 at stage 3): the masters and moments are cut over the whole ZeRO group
while each gathered region's compute shard is cut over ``zshard`` only, a
secondary shard refreshed after each update, so the gathers stay within
``zshard``.  Tensor parallelism (``mesh.model_parallel_size``, the ``tp``
axis): the engine makes the whole model it is given tensor-parallel in
place by its ``param_partition_rules()``
(``parallel/tensor_parallel.py``), and ZeRO partitions each rank's slices;
the norms sum the squares of split parameters over ``tp`` and count the
whole ones (LayerNorms, row-parallel biases) once.

``comm.overlap`` (the JAX engine's ``engine.py:474-600``) picks the
reduction's schedule: ``deferred_reduction`` (the default once enabled)
accumulates local gradients across the microbatches at every stage and
reduces once a batch, each sum divided by gas x world before its
collective (JAX ``_grads_for_batch_deferred``); ``bucket_mb`` splits that
reduction into collectives of whole leaves at stage 0, and at stages 1-3
into ranges of columns of every rank's partition cut at parameter edges,
of at most ``bucket_mb`` MiB unless one leaf is larger, issued in order
after the last backward and finished before the norm; ``schedule.mode:
off`` (or ``deferred_reduction: false``) reduces every microbatch at every
stage.  Stages 0-1 without ``comm.overlap`` take the same once-a-batch
path, one collective a region.  qwZ keeps the per-microbatch schedule, as in the JAX engine.  Each
step's reduction is recorded in the comms logger's step record
(:attr:`comm_footprint`: the schedule, the collectives and their analytic
wire bytes, ``telemetry/wire.py``).
Where microbatches carry ``loss_mask``, each rank's masked mean is first
weighted by its share of the microbatch's mask over all ranks
(:meth:`_mask_weights`), so that the mean over ranks, of the losses and of
the gradients, is the global masked mean the JAX engine takes over the
dp-sharded rows (train, eval and the legacy API alike).  qgZ
(``comm.quantized`` or ``zero_quantized_gradients`` at stage 0) reduces
each parameter's mean gradient of at least ``group_size x world`` elements
through ``comm.all_reduce_quantized`` (B5 on the card), the smaller ones
exactly, as the JAX engine does; under ``comm.overlap`` the large ones go
through one quantized collective a ``bucket_mb`` bucket.  1-bit Adam
(``onebitadam``, stage 0): exact Adam on the mean gradient, which is the
exact mean for the first ``freeze_step`` optimizer steps and then
``comm/compressed.py`` ``onebit_all_reduce`` per parameter, with this
rank's error feedback (volatile: not in checkpoints, zero after a load).

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

MoE (a model with ``moe.Experts``, the mesh's ``ep`` axis): the engine
keeps each ``ep`` rank's share of every layer's stacked experts and hands
the MoE layers the ZeRO group, over which their routing is global, and the
``ep`` group, over which their tokens move (``moe/sharded_moe.py``).  The
experts' parameters get regions of their own, cut and reduced over the
expert-data-parallel group (the ZeRO axes less ``ep``; ``zshard`` under
MiCS), the others over the ZeRO group, at every stage; the norms and LAMB
sum each expert piece over its group and then over ``ep``; checkpoints
write the experts whole.  At ``ep`` > 1, 1-bit Adam and qgZ raise and the
deferred reduction falls back to the per-microbatch schedule, as in the
JAX engine.

Progressive layer drop draws its coins from a generator seeded alike on
every rank (from ``config.seed`` and the step), so every rank drops the
same blocks; LAMB's trust ratio takes each parameter's whole norm, its
pieces' squares summed over the ranks in one collective; the chunked loss
runs inside the head's call, so stage 3 gathers the head's weight around
it.  ``comm.overlap.prefetch_depth`` runs the engine's loader that many
steps ahead (``dataloader.DevicePrefetchingLoader``).

Offload (``zero_optimization.offload_optimizer``, the JAX engine's
``engine.py:184-217``): with ``device: "cpu"`` each rank's fp32 masters and
optimizer state (its partitions at stages 1-3) live in pinned host memory,
are copied to the card for the update (the same device update, B6 under
FusedAdam) and back after it (``swap_tensor.py``); ``"nvme"`` also moves the
optimizer state to files between steps through the aio pool, its reads
running while the card computes the gradients.  ``host_update`` (stage 0,
one process, Adam/AdamW/CPUAdam, not fp16) runs the update on the host
cores instead (``ops/adam/cpu_adam.py``): the card holds the compute
parameters and the gradients and no fp32 master or moment; the clipped fp32
gradients come down in one copy into pinned memory (``wire_dtype: "bf16"``
halves its bytes, and the native Adam reads them as bf16), the native Adam
updates the host masters in place, and
the masters are cast to the compute type on the host, so the copy up moves
the compute bytes.  :attr:`offload_stats` holds the last step's transfers
and their seconds.  :meth:`destroy` removes the NVMe tier's files.

``comm.overlap.schedule.mode: auto`` (the JAX engine's ``_init_schedule``
and ``ScheduledStepFn``): ``comm/schedule.py`` ``plan_schedule`` scores the
reduction's schedules and bucket sizes against ``telemetry/wire.py``'s
figure for the card and the process group's backend (and the calibration's
``compute_s``, ``DST_TUNER_CACHE``), and the engine runs the one it picks
(:attr:`_sched_plan`, its ``tag`` in :attr:`comm_footprint`).  At stages
0-2 over several processes the plain reduction is then issued from
gradient hooks (:meth:`_install_hooks`): each collective of the manual
path leaves, asynchronously, as soon as the backward has finished every
gradient it reads, and the step waits for them before the norm -- the same
bits as ``manual`` with the plan's bucket.  The first planned step records
its collectives (:attr:`scheduled_step`: ``n_collectives``, ``n_hoisted``,
``sites``).  ``schedule.memory`` at stage 3: ``static`` with
``hbm_budget_bytes`` raises ``HBMBudgetError`` at construction where every
compute parameter whole does not fit, ``auto`` checks the largest one and,
under ``mode: auto``, publishes the first step's gather/release plan
(:attr:`memory_plan`, ``comm/memplan.py``) -- analysis: the gathers do not
move.

Not ported yet (raising ``NotImplementedError``, each naming its ROADMAP
Queue A item): eigenvalue, compression and the step telemetry ('The rest of
the surface').
"""

import collections
import contextlib
import functools
import math
import os
import re
import time

import numpy as np
import torch

from .. import comm
from ..accelerator import resolve_device
from ..parallel import topology as topo
from ..utils.logging import log_dist, logger
from ..comm.overlap import AsyncOpHandle, apply_xla_latency_hiding, bucketize
from ..sequence import bind_sequence_parallel
from .config import COMM_DTYPES, DeeperSpeedConfig, sp_qgz_refusal
from .lr_schedules import get_lr_schedule_fn
from .optimizers import build_optimizer, identity
from .swap_tensor import DeviceCopies, pin_into_one
from .precision import (
    MixedPrecisionPolicy,
    has_inf_or_nan,
    init_loss_scale,
    update_loss_scale,
)
from .zero import stage3
from .zero.quantized import fused_flat_reduce
from .zero.sharding import build_partition_plan, unit_of

# where a kind of region is cut (``part``), replicated under MiCS
# (``replica``) and reduced whole (``reduce``): the dense parameters over
# the ZeRO group, the MoE experts over the expert-data-parallel group
_Layout = collections.namedtuple("_Layout", "part replica reduce")


def _result(h):
    """A collective's result: its handle waited for, or the value itself."""
    return h.wait() if isinstance(h, AsyncOpHandle) else h


class _HookedReduction:
    """A gradient reduction issued from the backward (``schedule.mode:
    auto``): ``covers[k]`` lists the parameters (indices into ``params``)
    whose gradients the k-th collective of the planned issue order reads;
    ``issue(k)`` issues it and returns the call that finishes it.  Between
    :meth:`begin` and :meth:`end`, the hook on each parameter runs
    ``on_grad(i, p)`` once its gradient is final, then issues, in order,
    every collective whose parameters are all final (one ready early waits
    for those before it: every rank issues in one order).  :meth:`end`
    takes the parameters whose hooks never ran (the loss did not reach
    them) through ``on_missing(i)``, issues the rest and returns the
    finishing calls in issue order.  A collective that fails raises in the
    backward; nothing falls back.  ``recorder`` (a ``SiteRecorder``) marks
    the calls made from a hook as such."""

    def __init__(self, params, covers, issue):
        self._covers, self._issue = covers, issue
        self._units_of = [[] for _ in params]
        for k, idx in enumerate(covers):
            for i in idx:
                self._units_of[i].append(k)
        self._active = False
        self.recorder = None
        self.divisor = 1
        for i, p in enumerate(params):
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(functools.partial(self._hook, i))

    def begin(self, on_grad, divisor):
        self._on_grad, self.divisor = on_grad, divisor
        self._remaining = [len(c) for c in self._covers]
        self._seen = [False] * len(self._units_of)
        self._next, self._finish = 0, []
        self._active = True

    def _hook(self, i, p):
        if not self._active:
            return
        if self._on_grad is not None:
            self._on_grad(i, p)
        self._mark(i)
        self._issue_ready("hook")

    def _mark(self, i):
        self._seen[i] = True
        for k in self._units_of[i]:
            self._remaining[k] -= 1

    def _issue_ready(self, where):
        with self.recorder.issuing(where) if self.recorder else contextlib.nullcontext():
            while self._next < len(self._covers) and self._remaining[self._next] == 0:
                self._finish.append(self._issue(self._next))
                self._next += 1

    def end(self, on_missing):
        self._active = False
        for i, seen in enumerate(self._seen):
            if not seen:
                on_missing(i)
                self._mark(i)
        self._issue_ready("step")
        finish, self._finish = self._finish, []
        return finish


class DeeperSpeedEngine:
    # at sp > 1 each rank holds its slice of every sequence (the model bound
    # to the sp group); an engine that runs whole sequences on every sp
    # rank sets it False
    _SEQ_SLICED = True

    def __init__(self, model, config, optimizer=None, model_parameters=None,
                 loss_fn=None, training_data=None, collate_fn=None,
                 lr_scheduler=None, device=None):
        if not isinstance(config, DeeperSpeedConfig):
            config = DeeperSpeedConfig(config,
                                       world_size=topo.get_mesh().data_parallel_size)
        self.config = config
        self.device = resolve_device(device)
        self.mesh = topo.get_mesh()
        # the ZeRO group of this rank's tensor-parallel slice; rank is the
        # data-parallel index
        self.group = comm.get_data_parallel_group()
        self.world, self.rank = self.group.size(), self.group.rank()
        # sequence parallelism: the ZeRO group is the batch group (the
        # ranks of different rows) times the sp group (the slices of one
        # sequence), sp innermost
        self.sp_group = comm.get_sequence_parallel_group()
        self.batch_group = comm.get_batch_parallel_group()
        if config.world_size != self.world:
            raise ValueError(f"config built for {config.world_size} data-parallel "
                             f"processes, the mesh has {self.world}")
        self._init_layout()

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
        self._stage3_model(model)

        self.precision = MixedPrecisionPolicy(config)
        self._init_offload()
        self._init_qgz(model)
        # the type the data-parallel reduction runs in (the JAX engine's
        # ``reduce_dtype or accum_dtype``)
        self._comm_dtype = (COMM_DTYPES[config.communication_data_type]
                            or self._accum_dtype)
        self._init_schedule(model)
        self._init_memory(model)
        if loss_fn is None:
            if not hasattr(model, "loss_fn"):
                raise ValueError("pass loss_fn= or use a model exposing .loss_fn()")
            loss_fn = model.loss_fn()
        self._loss_fn = loss_fn

        self.module = model.to(self.device)
        if model_parameters is not None:
            self.module.load_state_dict(model_parameters)
        self._tp_dims = {}          # tp-split parameter -> its split dim
        if self.mesh.tp > 1:
            if not hasattr(self.module, "param_partition_rules"):
                raise ValueError("tensor parallelism (tp > 1) needs a model with "
                                 "param_partition_rules()")
            from ..parallel.tensor_parallel import shard_module

            self._tp_dims = shard_module(self.module, self.module.param_partition_rules(),
                                         self.tp_group)
        if self.sp_group.size() > 1 and self._SEQ_SLICED:
            bind_sequence_parallel(self.module, self.sp_group)
        self._init_experts()
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
                                      mup_multipliers=mup,
                                      whole_sq=self._whole_sq if (
                                          self._partitioned() or self.mesh.tp > 1)
                                      else None)
            base_lr = config.optimizer.params.lr
        else:
            self.tx = identity()
        self.optimizer = self.tx
        self.opt_state = self.tx.init(self.master_params)
        self._init_offload_state()

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
        # the training randomness: dropout and token subsets, seeded by the
        # data-parallel index (the tp ranks of a slice draw alike); the
        # layer-drop coins, alike on every rank (reseeded each step)
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(config.seed + self.rank)
        self._pld_rng = torch.Generator(device=self.device)
        self.step_count = 0          # optimizer steps taken (skips excluded)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._last_metrics = {}
        self._acc_count = 0          # microbatches in the accumulation buffer
        self._reduced = False        # allreduce_gradients() ran for this step
        self._cached_loss = None
        self.comm_footprint = []     # the last step's gradient-reduction record

        # the data-efficiency schedulers precede the loader: deepspeed_io's
        # curriculum-sampling branch reads them
        self._init_data_efficiency()
        self.training_dataloader = None
        self._data_iterator = None
        self._prefetcher = None
        if training_data is not None:
            from .dataloader import RepeatingLoader

            self.training_dataloader = self.deepspeed_io(training_data,
                                                         collate_fn=collate_fn)
            self._data_iterator = iter(RepeatingLoader(self.training_dataloader))

    # ------------------------------------------------------- process checks
    def _init_layout(self):
        """The groups of the mesh the engine reduces and gathers over:
        ``tp_group``; ``_part_group``, over which a ZeRO partition is cut
        (``zshard`` under MiCS, else the ZeRO group), ``_replica_group``,
        over which MiCS's partitions are replicated (``dp``), and whether
        hpZ cuts the stage-3 compute shards over ``zshard``."""
        cfg, mesh = self.config, self.mesh
        self.tp_group = comm.get_model_parallel_group()
        self.zshard_group = comm.get_zero_param_parallel_group()
        if cfg.zshard_size > 1 and mesh.zshard != cfg.zshard_size:
            raise ValueError(f"the mesh's zshard={mesh.zshard} differs from the config's "
                             f"MiCS / hpZ size {cfg.zshard_size}")
        self._mics = cfg.mics_shard_size > 1
        # hpZ below stage 3 partitions nothing more (as in the JAX package)
        self._hpz = cfg.zero_hpz_partition_size > 1 and cfg.zero_stage == 3
        self._part_group = self.zshard_group if self._mics else self.group
        self._replica_group = (comm.get_data_parallel_replica_group()
                               if self._mics and mesh.dp > 1 else None)
        # stage 1-3 partitions: their number and this rank's
        self._parts, self._part_index = self._part_group.size(), self._part_group.rank()
        # MoE: the experts are spread over ep and cut over the rest
        self.ep_group = comm.get_expert_parallel_group()
        self.expert_group = comm.get_expert_data_parallel_group()
        self._layouts = {
            False: _Layout(self._part_group, self._replica_group, self.group),
            True: _Layout(self.zshard_group if self._mics else self.expert_group,
                          self._replica_group, self.expert_group)}

    def _init_experts(self):
        """MoE: keep this ``ep`` rank's experts of every layer and hand the
        layers their groups (the batch group their routing is global over,
        the ``ep`` group their tokens move in).  :attr:`_expert_names` are
        the expert parameters, whose leading dim ``ep`` splits."""
        from ..moe.experts import Experts
        from ..moe.sharded_moe import MOELayer

        ep, i_ep = self.ep_group.size(), self.ep_group.rank()
        self._expert_names = set()
        for name, mod in self.module.named_modules():
            if isinstance(mod, Experts):
                if ep > 1:
                    mod.shard(i_ep, ep)
                self._expert_names.update(f"{name}.{p}" for p, _ in mod.named_parameters())
            elif isinstance(mod, MOELayer):
                mod.set_groups(self.group, self.ep_group, self.sp_group)

    def _init_offload(self):
        """``offload_optimizer`` and ``offload_param`` (the JAX engine's
        ``engine.py:178-217``): which tier holds the masters and the
        optimizer state, the host optimizer of ``host_update`` and the NVMe
        tier's swapper."""
        cfg = self.config
        off = cfg.offload_optimizer
        if cfg.offload_param is not None and cfg.offload_param.device != "none":
            log_dist("offload_param is accepted and not acted on, as in the JAX engine: "
                     "the parameter tier is ZeroInfinityEngine (runtime/zero/infinity.py), "
                     "built directly", ranks=[0])
        self._host_adam = None
        self._opt_swapper = None
        self._opt_home = None
        self.offload_stats = {}
        if off is not None and off.host_update:
            self._init_host_update()
        tier = cfg.offload_optimizer_device
        self._offload = tier in ("cpu", "nvme") and self._host_adam is None
        self._host_state = self._offload or self._host_adam is not None
        self._pin = self.device.type == "cuda"
        if tier == "nvme":
            from .swap_tensor import OptimizerStateSwapper

            self._opt_swapper = OptimizerStateSwapper(
                os.path.join(off.nvme_path, "zero_opt_swap"), num_threads=off.buffer_count,
                pipeline_write=off.pipeline_write)

    def _init_host_update(self):
        """The host update's refusals, in the JAX engine's terms
        (``_init_host_update``), and its native optimizer."""
        from ..ops.adam.cpu_adam import DeeperSpeedCPUAdam
        from .config import OptimizerParams
        from .constants import ADAM_OPTIMIZER, ADAMW_OPTIMIZER, CPU_ADAM_OPTIMIZER

        cfg = self.config
        if cfg.zero_stage != 0:
            raise NotImplementedError(
                "offload_optimizer.host_update requires zero stage 0 (the host update "
                "consumes full-replica grads; sharded state belongs on the device path)")
        if self.precision.is_fp16:
            raise NotImplementedError("host_update does not compose with fp16 dynamic "
                                      "scaling; use bf16 (masters are fp32 on host either way)")
        if self._update_processes() > 1:
            raise NotImplementedError("host_update is single-process (grads fetch to one host)")
        opt = cfg.optimizer
        opt_type = opt.type.lower() if opt else ADAM_OPTIMIZER
        if opt_type not in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, CPU_ADAM_OPTIMIZER):
            raise NotImplementedError(f"host_update supports Adam/AdamW/CPUAdam, got {opt.type}")
        p = opt.params if opt else OptimizerParams()
        self._host_adam = DeeperSpeedCPUAdam(lr=p.lr, betas=tuple(p.betas), eps=p.eps,
                                             weight_decay=p.weight_decay,
                                             adamw_mode=opt_type == ADAMW_OPTIMIZER)
        self._wire_dtype = (torch.bfloat16 if cfg.offload_optimizer.wire_dtype == "bf16"
                            else torch.float32)

    def _update_processes(self):
        """The processes that update one copy of the model together: the
        world (a pipeline engine: its stage's processes)."""
        return comm.get_world_size()

    def _init_offload_state(self):
        """Host update: the moments, the gradients' landing buffer and the
        cast's staging buffers, pinned and allocated once, and no optimizer
        state in the engine.  The host tiers: the optimizer state moved into
        one pinned buffer."""
        f32, pin = torch.float32, self._pin
        flat = self._master_flat
        if self._host_adam is not None:
            self.opt_state = None
            m, v = (torch.zeros(flat.numel(), dtype=f32, pin_memory=pin) for _ in range(2))
            # the gradients' landing buffer, in the wire's type: the native
            # Adam reads a bf16 wire's as it is
            self._host_grad = torch.empty(flat.numel(), dtype=self._wire_dtype,
                                          pin_memory=pin)
            self._host_grads = {}
            for n, t in self.master_params.items():
                span = slice(t.storage_offset() - flat.storage_offset(),
                             t.storage_offset() - flat.storage_offset() + t.numel())
                self._host_adam._moments[n] = (m[span], v[span])
                self._host_grads[n] = self._host_grad[span]
            self._host_stage = [None if region.dtype == f32 else
                                torch.empty(region.padded, dtype=region.dtype, pin_memory=pin)
                                for region, *_ in self._compute]
        elif self._offload:
            from ..utils.tree import tree_leaves

            state = [t for t in tree_leaves(self.opt_state) if isinstance(t, torch.Tensor)]
            if state:
                self._opt_home = pin_into_one(state, pin)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _ensure_opt_resident(self):
        """NVMe tier: the optimizer state back in host memory (the JAX
        engine's ``_ensure_opt_resident``)."""
        if self._opt_swapper is not None:
            self._opt_swapper.swap_in()

    def _spill_opt(self):
        """NVMe tier: the optimizer state to disk until the next step."""
        if self._opt_swapper is not None and self._opt_home is not None:
            self._opt_swapper.swap_out([self._opt_home])

    def destroy(self):
        """Release what the engine owns: the NVMe tier's aio pool and swap
        directory."""
        if self._opt_swapper is not None:
            self._opt_swapper.close()
            self._opt_swapper = None

    def _stage3_model(self, model):
        """Stage 3's one change to the model: it recomputes each unit."""
        mcfg = getattr(model, "config", None)
        if self.config.zero_stage == 3 and getattr(mcfg, "remat", False):
            # the stage-3 wrapper recomputes every unit (it gathers inside
            # the recompute), so block recompute would run twice
            model.replace_config(remat=False)

    def _init_qgz(self, model=None):
        """qgZ and 1-bit Adam (the JAX engine's ``engine.py:287-362``): the
        compressed data-parallel reductions, at stage 0 only."""
        cfg = self.config
        cq = cfg.comm_quantized
        self._onebit = (cfg.optimizer is not None
                        and cfg.optimizer.type.lower() == "onebitadam")
        if self._onebit:
            if cfg.zero_stage > 0:
                raise ValueError("onebitadam requires zero stage 0 (1-bit Adam does "
                                 "not compose with ZeRO partitioning)")
            if self.precision.is_fp16:
                raise ValueError("onebitadam supports fp32/bf16 only")
            if self.mesh.ep > 1 or self.mesh.zshard > 1:
                raise ValueError("onebitadam compresses over the dp axis; ep/zshard must "
                                 "be 1 (sp or tp compose)")
            if self.mesh.sp > 1 and self.mesh.tp > 1:
                # the JAX engine's refusal, in its words
                raise NotImplementedError(
                    "onebitadam supports sp OR tp alongside dp, not both "
                    "(XLA SPMD device-group expansion limitation)")
            if self.batch_group.size() == 1:
                logger.warning("onebitadam: dp=1, nothing to compress; "
                               "running plain Adam")
                self._onebit = False
        self._qgz = bool(cq.enabled)
        if cfg.zero_quantized_gradients and not self._qgz:
            if cfg.zero_stage == 0:
                self._qgz = True
            else:
                logger.warning("zero_quantized_gradients: the qgZ reduction requires "
                               "stage 0 (stage %d keeps the plain reduction); ignoring",
                               cfg.zero_stage)
        if self._qgz:
            if self._onebit:
                raise ValueError("comm.quantized and onebitadam are mutually exclusive "
                                 "gradient compressions")
            if cq.enabled and cfg.zero_stage > 0:
                raise ValueError("comm.quantized requires zero stage 0: the qgZ "
                                 "reduction needs replicated masters")
            if self.precision.is_fp16:
                raise ValueError("comm.quantized supports fp32/bf16 only")
            if self.mesh.ep > 1:
                raise ValueError("comm.quantized: ep must be 1 (MoE routing assumes the "
                                 "GSPMD reduction paths)")
            if self.mesh.sp > 1 and self.mesh.tp > 1:
                raise NotImplementedError(
                    "comm.quantized supports sp OR tp alongside dp, not both "
                    "(XLA SPMD device-group expansion limitation)")
            if (self.mesh.sp > 1 and getattr(getattr(model, "config", None),
                                             "seq_parallel_mode", None) == "ring"):
                raise sp_qgz_refusal(
                    "seq_parallel_mode 'ring'",
                    "ValueError: The context mesh AbstractMesh(...) should match the mesh")
            if self.batch_group.size() == 1:
                logger.warning("comm.quantized: dp*zshard=1, nothing to quantize; "
                               "running plain reduction")
                self._qgz = False
        de = cfg.data_efficiency
        if ((self._onebit or self._qgz) and de.enabled
                and dict(de.data_routing.get("random_ltd", {})).get("enabled")):
            raise NotImplementedError(
                f"{'onebitadam' if self._onebit else 'comm.quantized'} + random-LTD is "
                f"not supported (the compressed reduction takes per-rank means)")
        # the two-hop schedule's first hop (JAX ``_hier_axes``): the named
        # axis, else zshard where both zshard and dp span several processes
        self._qgz_intra = None
        if cq.intra_axis is not None:
            self._qgz_intra = comm.get_axis_group(cq.intra_axis)
        elif self.mesh.zshard > 1 and self.mesh.dp > 1:
            self._qgz_intra = self.zshard_group
        # the compressed loops sum microbatch gradients in fp32, whatever
        # grad_accum_dtype says (JAX ``_grads_for_batch_qgz`` / ``_onebit``)
        self._accum_dtype = (torch.float32 if self._qgz or self._onebit
                             else self.precision.accum_dtype)

    def _init_schedule(self, model):
        """``comm.overlap`` and ``comms_logger`` (the JAX engine's
        ``engine.py:474-600``): which microbatches the reduction waits for,
        its buckets, qwZ; under ``schedule.mode: auto`` the cost model's plan
        (``comm/schedule.py`` ``plan_schedule``), run with its reductions
        issued from gradient hooks (:meth:`_install_hooks`)."""
        from ..comm import memplan, schedule

        cfg = self.config
        ov = cfg.comm_overlap
        comm.configure(cfg)
        self._qwz = cfg.zero_stage == 3 and cfg.zero_quantized_weights
        mode = ov.schedule.mode if ov.enabled else "off"
        self._schedule_mode = mode
        schedule.set_active_mode(mode)
        # the memory planner's mode and budget, read only under
        # comm.overlap as in the JAX engine, and the calibration both
        # planners price with (DST_TUNER_CACHE)
        self._memory_mode = ov.schedule.memory if ov.enabled else "off"
        self._hbm_budget_bytes = ov.schedule.hbm_budget_bytes if ov.enabled else None
        self._calibration = memplan.load_calibration()
        memplan.set_active_memory_mode(self._memory_mode)
        self.memory_plan = None
        self._sched_plan = None
        # what the deferred path does not serve here: qwZ's gathers and MoE
        # at ep > 1 (the JAX engine also blocks tp > 1; the port's deferred
        # reduction runs there)
        blockers = []
        if self._qwz:
            blockers.append("zero_quantized_weights (the quantized gather keeps the "
                            "per-microbatch reduction, as in the JAX engine)")
        if self.mesh.ep > 1:
            blockers.append("ep > 1 (MoE routing needs the GSPMD paths)")
        deferrable = (ov.enabled and ov.deferred_reduction
                      and not self._onebit and not self._qgz)
        eligible = deferrable and not blockers and self.world > 1
        if mode == "manual" and deferrable and self._qwz:
            logger.warning("comm.overlap.deferred_reduction disabled: "
                           "zero_quantized_weights (the quantized gather keeps the "
                           "per-microbatch reduction, as in the JAX engine)")
        if mode == "manual" and deferrable and self.mesh.ep > 1:
            logger.warning("comm.overlap.deferred_reduction disabled: ep > 1 (MoE routing "
                           "needs the GSPMD paths) -- falling back to the per-microbatch "
                           "reduction schedule (comm.overlap.schedule.mode=auto plans "
                           "these regimes instead)")
        defer = mode == "manual" and eligible
        if mode == "auto":
            n_params = sum(p.numel() for p in model.parameters())
            itemsize = torch.empty(0, dtype=self._comm_dtype).element_size()
            cal = self._calibration
            self._sched_plan = schedule.plan_schedule(
                grad_bytes=n_params * itemsize,
                gas=cfg.gradient_accumulation_steps,
                n_ranks=self.world,
                deferred_allowed=eligible,
                blockers=tuple(blockers),
                bucket_mb=ov.bucket_mb,
                qgz=self._qgz or self._onebit,
                device_kind=memplan.device_kind_of(self.device),
                compute_s=cal.compute_s if cal is not None and cal.compute_s > 0 else None,
                backend=self.group.backend() if self.world > 1 else "nccl")
            defer = self._sched_plan.grad_schedule == "deferred" and eligible
            log_dist("comm.schedule[auto]: " + self._sched_plan.describe(), ranks=[0])
        # stages 2-3 reduce each microbatch's gradients unless deferred;
        # under comm.overlap without the deferred schedule, so do stages 0-1
        self._per_micro = (not (self._qgz or self._onebit or defer)
                           and (cfg.zero_stage >= 2 or (ov.enabled and self.world > 1)))
        # every other plain reduction is the once-a-batch one, in buckets
        self._deferred = not (self._qgz or self._onebit or self._per_micro)
        # the accumulation buffer holds whole local gradients (every
        # region's padded length) unless stages 1-3 reduce-scatter them as
        # they are made
        self._acc_whole = cfg.zero_stage == 0 or not self._per_micro
        self._bucket_mb = ov.bucket_mb if ov.enabled else 0.0
        if self._sched_plan is not None and defer:
            self._bucket_mb = self._sched_plan.bucket_mb
        if ov.enabled and ov.xla_latency_hiding:
            apply_xla_latency_hiding()
        # steps of batches the engine's loader runs ahead (JAX ``engine.py:478-496``)
        self._prefetch_depth = ov.prefetch_depth if ov.enabled else 0
        # the eager counterpart of the JAX engine's ScheduledStepFn: under
        # auto, and not under the host update (JAX ``_schedule_jit``)
        self.scheduled_step = (schedule.ScheduledStep("train_step")
                               if mode == "auto" and self._host_adam is None else None)
        # the reductions issued from gradient hooks: stages 0-2 over
        # several processes, the plain (not quantized) reduction; stage 3's
        # gathers already reduce in their backward
        self._hook_issue = (self.scheduled_step is not None and cfg.zero_stage <= 2
                            and self.world > 1 and not (self._qgz or self._onebit))
        self._hooks = None
        self._pending = None        # the hook-issued buckets' finishing calls

    def _init_memory(self, model):
        """The stage-3 budget check (the JAX engine's ``engine.py:577-610``):
        ``memory: static`` with ``hbm_budget_bytes`` raises
        ``HBMBudgetError`` here when every compute parameter whole cannot fit;
        ``auto`` checks only the largest one, and its gather/release plan is
        taken from the first step (:attr:`memory_plan`)."""
        from ..comm import memplan
        from .zero.sharding import stage3_static_peak_bytes

        self._gather_ledger = stage3.GatherLedger()
        if self._memory_mode == "off" or self.config.zero_stage < 3:
            return
        dtype = self.precision.param_dtype
        itemsize = torch.empty(0, dtype=dtype).element_size()
        static_peak = stage3_static_peak_bytes((p.shape, dtype) for p in model.parameters())
        budget = self._hbm_budget_bytes
        if budget:
            if self._memory_mode == "static":
                memplan.assert_hbm_fit("zero-3 static param placement", static_peak, budget)
            else:
                biggest = max((p.numel() * itemsize for p in model.parameters()), default=0)
                memplan.assert_hbm_fit("zero-3 planned streaming (largest single leaf)",
                                       biggest, budget)
                log_dist(f"comm.memplan[auto]: zero-3 static residency "
                         f"{static_peak / 2**20:.1f} MiB vs budget {budget / 2**20:.1f} MiB "
                         f"-- gather/release points planned from the first step", ranks=[0])

    @property
    def _grad_schedule_tag(self):
        """Telemetry label of the gradient reduction's schedule in effect."""
        if self._sched_plan is not None:
            return self._sched_plan.tag
        return "per_microbatch" if self._per_micro else "deferred"

    # ------------------------------------------------------------------ state
    def _build_state(self):
        """The flat buffers of the partition plan (``zero/sharding.py``):
        masters and gradients hold this rank's partition of every region
        (the whole region at stage 0), the accumulation buffer whole local
        gradients (stages 0-1) or the partitions (stages 2-3), and the
        compute copy each region's whole buffer in its compute type (a
        partition of it for the regions stage 3 gathers; under hpZ its
        ``zshard`` part).  Every rank starts from its ZeRO group's first
        rank's weights."""
        named = dict(self.module.named_parameters())
        patterns = (self.module.no_cast_paths()
                    if hasattr(self.module, "no_cast_paths")
                    else [r"embed_in\.weight"])
        specs = {n: (tuple(p.shape), self.precision.compute_dtype(
            p, any(re.search(pat, n) for pat in patterns))) for n, p in named.items()}
        stage = self.config.zero_stage
        ex = self._layouts[True].part
        self.plan = plan = build_partition_plan(
            specs, stage, self._parts, self._part_index,
            self.config.param_persistence_threshold,
            {n: unit_of(n, self.module) for n in named} if stage == 3 else None,
            self._expert_names, ex.size(), ex.rank())
        self._order = plan.order
        dev, f32, accum = self.device, torch.float32, self._accum_dtype
        local, whole = plan.local_numel, self._acc_whole
        host = self._host_state         # the masters in (pinned) host memory
        self._master_flat = torch.empty(local, dtype=f32, device="cpu" if host else dev,
                                        pin_memory=host and self._pin)
        self._grad_flat = torch.zeros(local, dtype=f32, device=dev)
        acc_numel = sum(r.padded for r in plan.regions) if whole else local
        self._acc_flat = (self._grad_flat if accum == f32 and acc_numel == local else
                          torch.zeros(acc_numel, dtype=accum, device=dev))
        # 1-bit Adam's error feedback, laid out like the accumulation buffer
        self._onebit_error = (torch.zeros(acc_numel, dtype=f32, device=dev)
                              if self._onebit else None)
        self.master_params, self.grads = {}, {}
        self._params, self._acc_views = [], []   # whole-gradient accumulation
        self._error_views = []
        self._scatter = []      # per microbatch: (region, its parameters, acc region)
        self._compute = []      # (region, master partition, compute buffer, gathered)
        self._gathered_acc = []  # stage 3: accumulation regions the gathers feed
        units = {}
        acc_off = 0
        with torch.no_grad():
            for region, base in zip(plan.regions, plan.bases()):
                params = [named[n] for n in region.names]
                full = torch.zeros(region.padded, dtype=f32, device=dev)
                for p, off in zip(params, region.offsets):
                    full[off:off + p.numel()].copy_(p.detach().reshape(-1))
                reduce_group = self._layouts[region.expert].reduce
                if reduce_group.size() > 1:
                    comm.broadcast(full, 0, reduce_group)
                i0 = region.index * region.part
                master = self._master_flat[base:base + region.part]
                master.copy_(full[i0:i0 + region.part])
                for n, shape, a, b, at in region.pieces(region.index):
                    keep = shape if b - a == named[n].numel() else \
                        (b - a,) + (1,) * (len(shape) - 1)
                    span = slice(base + at, base + at + b - a)
                    self.master_params[n] = self._master_flat[span].view(keep)
                    self.grads[n] = self._grad_flat[span].view(keep)
                acc = acc_off if whole else base
                acc_off += region.padded
                acc_region = self._acc_flat[acc:acc + (region.padded if whole else
                                                       region.part)]
                if region.gathered:
                    # the gather's backward adds the whole local gradient
                    # (deferred) or this rank's reduced partition
                    lo, hi, gather = self._compute_shard(region)
                    shard = full[lo:hi].to(region.dtype, copy=True)
                    shard.requires_grad_(True)
                    gathered = stage3.GatheredRegion(
                        region, shard, gather, self._comm_dtype,
                        lambda g, acc=acc_region: acc.add_(g.to(acc.dtype)),
                        deferred=whole, quantized=self._qwz,
                        reduce=lambda x, r=region: self._reduce_partition(x, r),
                        ledger=self._gather_ledger,
                        label=f"{region.unit}#{len(units.get(region.unit, []))}")
                    units.setdefault(region.unit, []).append(gathered)
                    self._gathered_acc.append(acc_region)
                    for p in params:
                        p.data = torch.empty(0, dtype=region.dtype, device=dev)
                    self._compute.append((region, master, None, gathered))
                    continue
                self._params.extend(params)
                if self._per_micro:
                    self._scatter.append((region, params, acc_region))
                else:
                    for p, off in zip(params, region.offsets):
                        self._acc_views.append(acc_region[off:off + p.numel()].view(p.shape))
                        if self._onebit:
                            self._error_views.append(
                                self._onebit_error[acc + off:acc + off + p.numel()])
                if stage == 0 and region.dtype == f32 and not host:
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
        self._plan_buckets()
        if self._hook_issue:
            self._install_hooks()

    def _compute_shard(self, region):
        """``(lo, hi, group)``: the stretch of a gathered region this rank's
        compute shard holds and the group that gathers it -- the master
        partition over ``_part_group``, or under hpZ the ``zshard`` part."""
        if self._hpz:
            n = self.zshard_group.size()
            sec = region.padded // n
            lo = self.zshard_group.rank() * sec
            return lo, lo + sec, self.zshard_group
        lo = region.index * region.part
        return lo, lo + region.part, self._layouts[region.expert].part

    def _reduce_partition(self, x, region, async_op=False):
        """This rank's partition of the sum of ``x`` (a whole region's
        buffer in the communication type) over the ranks that reduce the
        region: a reduce-scatter over its partition group, then under MiCS
        an all-reduce over the replicas.  ``async_op="always"``: a handle
        whose ``wait()`` gives it (the reduce-scatter is issued now, the
        replicas' all-reduce at the wait)."""
        lay = self._layouts[region.expert]

        def replicas(y):
            if lay.replica is not None:
                comm.all_reduce(y, group=lay.replica, log_name="grad_reduce")
            return y

        if async_op:
            h = comm.reduce_scatter(x, lay.part, log_name="grad_reduce", async_op=async_op)
            return AsyncOpHandle(None, lambda: replicas(h.wait()))
        return replicas(comm.reduce_scatter(x, lay.part, log_name="grad_reduce"))

    def _plan_buckets(self):
        """The once-a-batch reduction's collectives, in issue order: at stage 0
        ``("all_reduce", lo, hi, group)``, contiguous ranges of the flat
        buffer along :func:`bucketize` of the leaves (the experts' apart,
        over their group); at stages 1-3 ``("reduce_scatter", off, part,
        c0, c1, base, region)``, columns ``[c0, c1)`` of every rank's
        partition of the region at ``off`` of the whole buffer (``base`` in
        this rank's), cut where any rank's piece of a parameter starts or
        ends and grouped by :func:`bucketize`.  Without ``bucket_mb``: one
        collective over the whole buffer (stage 0; one over the experts) or
        a region."""
        self._buckets = []
        if not self._deferred:
            return
        itemsize = torch.empty(0, dtype=self._comm_dtype).element_size()
        if self.plan.stage == 0:
            runs, start = [], 0
            for region in self.plan.regions:
                if runs and runs[-1][0] == region.expert:
                    runs[-1][2] += len(region.names)
                else:
                    runs.append([region.expert, start, len(region.names)])
                start += len(region.names)
            for expert, first, count in runs:
                sizes = [v.numel() for v in self._acc_views[first:first + count]]
                lo0 = sum(v.numel() for v in self._acc_views[:first])
                starts = (lo0 + np.concatenate([[0], np.cumsum(sizes)])).tolist()
                for b in bucketize([s * itemsize for s in sizes], self._bucket_mb):
                    self._buckets.append(("all_reduce", starts[b[0]], starts[b[-1] + 1],
                                          self._layouts[expert].reduce))
            return
        off = 0
        for region, base in zip(self.plan.regions, self.plan.bases()):
            n, part = region.parts, region.part
            cuts = {0, part}
            for start in list(region.offsets) + [region.numel]:
                for r in range(n):
                    if 0 < start - r * part < part:
                        cuts.add(start - r * part)
            cuts = sorted(cuts)
            units = list(zip(cuts[:-1], cuts[1:]))
            for b in bucketize([(hi - lo) * n * itemsize for lo, hi in units],
                               self._bucket_mb):
                self._buckets.append(("reduce_scatter", off, part, units[b[0]][0],
                                      units[b[-1]][1], base, region))
            off += region.padded

    def _bucket_spans(self, bucket):
        """The ranges of the accumulation buffer a bucket of
        :meth:`_plan_buckets` reads: one at stage 0, at stages 1-2 its
        columns of every rank's partition."""
        if bucket[0] == "all_reduce":
            return [bucket[1:3]]
        _, off, part, c0, c1, _, region = bucket
        return [(off + r * part + c0, off + r * part + c1) for r in range(region.parts)]

    def _install_hooks(self):
        """The reduction issued from gradient hooks (``schedule.mode: auto``
        at stages 0-2, the eager counterpart of the JAX hoist pass,
        :class:`_HookedReduction`).  Its collectives are those of the
        manual path -- under the deferred plan the buckets of
        :meth:`_plan_buckets`, issued from the last microbatch's backward
        after each hook adds its gradient into the accumulation buffer;
        under the per-microbatch plan the regions of :meth:`_scatter_micro`,
        from each microbatch's backward -- each issued once every
        parameter piece it reads is final, so the bits are the manual
        path's.  They issue in the order the backward finishes them, alike
        on every rank: latest first by the earliest parameter (in the
        module's order) each reads."""
        index = {id(p): i for i, p in enumerate(self._params)}
        if self._per_micro:
            units = [[index[id(p)] for p in params] for _, params, _ in self._scatter]

            def issue_unit(j):
                return self._issue_region(self._scatter[j], "always")
        else:
            base = self._acc_flat.storage_offset()
            spans = [(v.storage_offset() - base, v.numel()) for v in self._acc_views]
            units = [[i for i, (a, n) in enumerate(spans)
                      if any(lo < a + n and a < hi for lo, hi in self._bucket_spans(bucket))]
                     for bucket in self._buckets]

            def issue_unit(j):
                return self._issue_bucket(self._buckets[j], self._hooks.divisor * self.world,
                                          "always")
        position = {id(p): i for i, p in enumerate(self.module.parameters())}
        first = [min((position[id(self._params[i])] for i in idx), default=-1)
                 for idx in units]
        order = sorted(range(len(units)), key=lambda j: (-first[j], -j))
        self._hooks = _HookedReduction(self._params, [units[j] for j in order],
                                       lambda k: issue_unit(order[k]))

    def _hook_add(self, i, p):
        """The last microbatch's gradient of ``self._params[i]`` into its
        accumulation view, as :meth:`_accumulate` adds it."""
        v = self._acc_views[i]
        g = p.grad if self._accum_dtype == torch.float32 else p.grad.to(self._accum_dtype)
        if self._acc_count == 0:
            v.copy_(g)
        else:
            v.add_(g)

    def _hook_missing(self, i):
        """A parameter the backward gave no gradient (the loss did not reach
        it), as :meth:`_accumulate` treats it."""
        if not self._per_micro and self._acc_count == 0:
            self._acc_views[i].zero_()

    @torch.no_grad()
    def _refresh_compute(self, copies=None):
        """The compute copy from the masters (the JAX engine's
        ``cast_for_compute``): one cast copy per region on one rank, an
        all-gather of the cast partitions over several, and at stage 3 the
        cast partition alone for the regions gathered at use.  Masters in
        host memory are read through their device copies (``copies``, a
        ``DeviceCopies``, made here when not given); under the host update
        they are cast on the host and copied up (:meth:`_upload_compute`)."""
        if self._host_adam is not None:
            self._upload_compute()
            return
        if copies is None and self._host_state:
            copies = DeviceCopies(self.device)
        for region, master, buf, gathered in self._compute:
            if copies is not None:
                master = copies(master)
            if gathered is not None and self._hpz:
                # hpZ's secondary shard: this rank's zshard part of the
                # region, gathered once from the primary partitions
                full = comm.all_gather_into(
                    torch.empty(region.padded, dtype=region.dtype, device=self.device),
                    master.to(region.dtype), self._layouts[region.expert].part,
                    log_name="hpz_refresh")
                lo, hi, _ = self._compute_shard(region)
                gathered.shard.copy_(full[lo:hi])
            elif gathered is not None:
                gathered.shard.copy_(master)
            elif buf is None:
                continue
            elif region.parts == 1:
                buf.copy_(master)
            else:
                comm.all_gather_into(buf, master.to(region.dtype),
                                     self._layouts[region.expert].part)

    def full_master_params(self):
        """Every fp32 master whole, by name, a copy (gathered from the
        ranks' partitions at stages 1-3 and the ``tp`` ranks' slices)."""
        return {n: t.clone() for n, t in self.gather_whole(self.master_params).items()}

    @torch.no_grad()
    def gather_whole(self, local, names=None):
        """Whole tensors by name from ``local``, a dict laid out like
        :attr:`master_params` (this rank's pieces: the masters or a
        per-parameter optimizer tree): views of ``local`` where a region is
        not partitioned, else gathered from the ranks' partitions, each
        tp-split parameter's slices joined along its split dim and each
        expert parameter's ``ep`` ranks' experts along dim 0 (a collective
        every rank calls).  ``names``: only these parameters, whole as
        above, from only the regions holding them (every rank names the
        same)."""
        out = {}
        for region, base in zip(self.plan.regions, self.plan.bases()):
            if names is not None and not set(region.names) & set(names):
                continue
            if region.parts == 1:
                out.update((n, local[n]) for n in region.names)
                continue
            part = torch.zeros(region.part, dtype=torch.float32, device=self.device)
            for n, _, a, b, at in region.pieces(region.index):
                part[at:at + b - a].copy_(local[n].reshape(-1))
            full = comm.all_gather_into(
                torch.empty(region.padded, dtype=torch.float32, device=self.device),
                part, self._layouts[region.expert].part)
            for n, shape, off in zip(region.names, region.shapes, region.offsets):
                out[n] = full[off:off + math.prod(shape)].view(shape)
        if names is not None:
            out = {n: out[n] for n in names}
        for n, dim in self._tp_dims.items():
            if n in out:
                out[n] = comm.all_gather(out[n].contiguous(), self.tp_group, axis=dim,
                                         log_name="tp_gather")
        if self.ep_group.size() > 1:
            for n in sorted(self._expert_names & out.keys()):
                out[n] = comm.all_gather(out[n].contiguous(), self.ep_group, axis=0,
                                         log_name="ep_gather")
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
        tp, i_tp = self.tp_group.size(), self.tp_group.rank()
        ep, i_ep = self.ep_group.size(), self.ep_group.rank()
        for region in self.plan.regions:
            for n, shape, a, b, _ in region.pieces(region.index):
                if n not in whole:
                    continue
                src = whole[n]
                if n in self._expert_names and ep > 1:
                    if src.dim() == 0 or src.shape[0] != shape[0] * ep:
                        raise ValueError(f"checkpoint {n}: shape {tuple(src.shape)}, the "
                                         f"model's {tuple(shape)} on each of {ep} ep ranks")
                    src = src.chunk(ep, 0)[i_ep]
                if n in self._tp_dims:
                    dim = self._tp_dims[n]
                    if src.dim() <= dim or src.shape[dim] != shape[dim] * tp:
                        raise ValueError(f"checkpoint {n}: shape {tuple(src.shape)}, the "
                                         f"model's {tuple(shape)} on each of {tp} tp ranks")
                    src = src.chunk(tp, dim)[i_tp]
                if tuple(src.shape) != tuple(shape):
                    raise ValueError(f"checkpoint {n}: shape {tuple(src.shape)}, "
                                     f"the model's {tuple(shape)}")
                local[n].view(-1).copy_(src.reshape(-1)[a:b])

    # ------------------------------------------------------------------ data
    def _to_device(self, mb):
        return {k: torch.as_tensor(v).to(self.device) for k, v in mb.items()}

    def _local(self, mb):
        """This rank's contiguous slice of the rows of a global microbatch
        (the rows the JAX batch sharding over dp x zshard x ep gives it), by
        its index in the batch group: the tp ranks of a slice, and the sp
        ranks of a row, take the same rows (:meth:`_seq_local` then cuts the
        sequence)."""
        n = self.batch_group.size()
        if n == 1:
            return mb
        rows = {len(v) for v in mb.values()}
        if len(rows) != 1 or next(iter(rows)) % n:
            raise ValueError(f"microbatch rows {sorted(rows)} not divisible by "
                             f"{n} processes")
        per, i = next(iter(rows)) // n, self.batch_group.rank()
        return {k: v[i * per:(i + 1) * per] for k, v in mb.items()}

    def _seq_local(self, micro):
        """Sequence parallelism: this rank's slice of the sequence (dim 1)
        of every [rows, S, ...] entry of each microbatch, by its ``sp``
        index (the JAX batch sharding's ``P(batch, "sp")``); ``input_ids``,
        ``labels`` and ``loss_mask`` are cut at the same columns (the labels
        come shifted, so no token crosses a slice's edge)."""
        p = self.sp_group.size()
        if p == 1 or not self._SEQ_SLICED:
            return micro
        i = self.sp_group.rank()

        def cut(k, v):
            if not isinstance(v, torch.Tensor) or v.dim() < 2:
                return v
            if v.shape[1] % p:
                raise ValueError(f"{k}: sequence length {v.shape[1]} not divisible by "
                                 f"sequence_parallel_size {p}")
            per = v.shape[1] // p
            return v[:, i * per:(i + 1) * per]
        return [{k: cut(k, v) for k, v in mb.items()} for mb in micro]

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
                                     sampler=data_sampler,
                                     num_shards=self.batch_group.size(),
                                     shard_index=self.batch_group.rank())

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

            if self.sp_group.size() > 1 and self._SEQ_SLICED:
                # the JAX engine draws each row's token subset over the
                # whole sequence; a rank here holds a slice of it
                raise NotImplementedError(
                    "random-LTD at mesh.sequence_parallel_size > 1 is not ported yet "
                    "(ROADMAP Queue A, 'Random-LTD over sequence slices')")

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
            # the coins: one generator, seeded alike on every rank from the
            # seed and the step (so a resumed run draws what it would have)
            self._pld_rng.manual_seed((self.config.seed * 1_000_003 + step) % (1 << 62))
            micro = [{**mb, "pld_theta": theta, "pld_rng": self._pld_rng} for mb in micro]
        ltd = None
        if self.random_ltd_scheduler is not None:
            ltd = int(self.random_ltd_scheduler.update(step))
        return micro, ltd

    # ------------------------------------------------------------- the step
    def _accumulate(self, loss, scale, last=False, divisor=None, grad=None):
        """Backward of one microbatch's ``loss`` (times ``scale`` under fp16;
        a pipeline stage's output seeded with its cotangent ``grad``
        instead) and its gradients, cast to the accumulation type, added into the
        accumulation buffer: whole at stages 0-1; at stages 2-3 this rank's
        partition of their sum over ranks (stage 3's gathered regions get
        theirs from the gather's backward).  ``train_batch`` gives the
        step's microbatch count (``divisor``) and whether this is its
        ``last``: under the hooks of :meth:`_install_hooks` the reduction is
        then issued from the backward."""
        if self._acc_count == 0:
            for acc in self._gathered_acc:
                acc.zero_()
        hooked = self._hooks is not None and divisor is not None and (self._per_micro or last)
        if hooked:
            self._hooks.begin(self._hook_add if not self._per_micro else None, divisor)
        if grad is not None:
            loss.backward(grad)
        else:
            (loss if scale is None else loss * scale).to(torch.float32).backward()
        if hooked:
            finish = self._hooks.end(self._hook_missing)
            if self._per_micro:
                for f in finish:
                    f()
            else:
                self._pending = finish      # waited for before the norm
        elif self._scatter:
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
        """The per-microbatch schedule: each region's microbatch gradients,
        in the communication type, reduce-scattered into this rank's
        partition (all-reduced where the region is whole) and added to its
        accumulation."""
        for entry in self._scatter:
            self._issue_region(entry)()

    def _issue_region(self, entry, async_op=False):
        """One region's collective of :meth:`_scatter_micro` (``entry``: the
        region, its parameters, its accumulation); returns the call that
        finishes it, adding the result to the accumulation."""
        region, params, acc_part = entry
        buf = torch.zeros(region.padded, dtype=self._comm_dtype, device=self.device)
        for p, off in zip(params, region.offsets):
            if p.grad is not None:      # a block PLD or random-LTD skipped
                buf[off:off + p.numel()].copy_(p.grad.reshape(-1))
        h = (comm.all_reduce(buf, group=self._layouts[region.expert].reduce,
                             log_name="grad_reduce", async_op=async_op)
             if region.parts == 1 else self._reduce_partition(buf, region, async_op))
        first = self._acc_count == 0

        def finish():
            part = _result(h)
            if first:
                acc_part.copy_(part)
            else:
                acc_part.add_(part.to(acc_part.dtype))
        return finish

    def _mask_weights(self, micro):
        """Per microbatch, this rank's weight ``n * count_r / max(count,
        1)``: ``count_r`` the sum of the rank's ``loss_mask``, ``count`` its
        sum over the ``n`` ranks of the group, all microbatches' counts in
        one all-reduce.  The group is the ZeRO group; under qgZ and 1-bit
        Adam it is the ``sp`` group (the JAX engine's compressed paths take
        per-row-rank means, global over the sequence).  None where the
        group is one process and without a mask, where nothing changes."""
        group = self.sp_group if self._qgz or self._onebit else self.group
        n = group.size()
        if n == 1 or not all("loss_mask" in mb for mb in micro):
            return None
        counts = torch.stack([mb["loss_mask"].to(torch.float32).sum() for mb in micro])
        total = comm.all_reduce(counts.clone(), group=group)
        return n * counts / total.clamp(min=1.0)

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
        1-3); the step's record of it goes to :attr:`comm_footprint`."""
        comm.comms_logger.begin_step()
        try:
            self._record_grad_reduce_wire(divisor)
            self._reduce(divisor)
        finally:
            self.comm_footprint = comm.comms_logger.end_step()

    def _reduce(self, divisor):
        if self._qgz:
            self._reduce_qgz(divisor)
        elif self._onebit:
            self._reduce_onebit(divisor)
        elif self._deferred:
            self._reduce_deferred(divisor)
        else:                       # reduced each microbatch: the mean is left
            acc, g = self._acc_flat, self._grad_flat
            acc.div_(divisor * self.world)
            if acc is not g:
                g.copy_(acc)

    def _reduce_deferred(self, divisor):
        """The once-a-batch schedule (JAX ``_grads_for_batch_deferred``):
        the local sums over the microbatches, divided by ``divisor x world``
        in the accumulation type and cast to the communication type, reduced
        bucket by bucket (:meth:`_plan_buckets`) into the fp32 gradient
        buffer; the buckets the backward's hooks issued are waited for, in
        their issue order."""
        pending, self._pending = self._pending, None
        if pending is not None:
            for finish in pending:
                finish()
            return
        for bucket in self._buckets:
            self._issue_bucket(bucket, divisor * self.world)()

    def _issue_bucket(self, bucket, d, async_op=False):
        """One bucket of :meth:`_reduce_deferred`, divided by ``d``: its
        collective issued (a stage-0 bucket is reduced in place where the
        accumulation and communication types agree); returns the call that
        finishes it into the fp32 gradient buffer."""
        acc, g, n = self._acc_flat, self._grad_flat, self.world
        cd = self._comm_dtype if n > 1 else acc.dtype
        if bucket[0] == "all_reduce":
            _, lo, hi, group = bucket
            x = acc[lo:hi].div_(d).to(cd)
            h = (comm.all_reduce(x, group=group, log_name="grad_reduce", async_op=async_op)
                 if group.size() > 1 else x)

            def finish():
                _result(h)
                if not (acc is g and x.dtype == acc.dtype):
                    g[lo:hi].copy_(x.to(acc.dtype))
            return finish
        _, off, part, c0, c1, base, region = bucket
        p = region.parts
        x = acc[off:off + p * part].view(p, part)[:, c0:c1].div_(d)
        y = x.to(cd).reshape(-1)
        h = self._reduce_partition(y, region, async_op) if n > 1 else y
        return lambda: g[base + c0:base + c1].copy_(_result(h).to(acc.dtype))

    def _reduce_onebit(self, divisor):
        """1-bit Adam (JAX ``_grads_for_batch_onebit``): each parameter's
        mean over the microbatches; below ``freeze_step`` optimizer steps
        its exact mean over the ranks, from then on ``onebit_all_reduce``
        with this rank's error feedback, over the batch group after the
        exact mean over ``sp``."""
        from ..comm.compressed import onebit_all_reduce

        acc = self._acc_flat                 # fp32, the gradient buffer itself
        acc.div_(divisor)
        if self.step_count < self.config.optimizer.params.freeze_step:
            comm.all_reduce(acc, comm.ReduceOp.AVG, self.group, log_name="grad_reduce")
            return
        self._sp_mean(acc)
        for v, e in zip(self._acc_views, self._error_views):
            mean, err = onebit_all_reduce(v, self.batch_group, e)
            v.copy_(mean)
            e.copy_(err.reshape(-1))

    def _sp_mean(self, acc):
        """The compressed reductions at ``sp`` > 1: the exact mean over the
        sequence's slices first, so that the compressed collective over the
        batch group sees each row rank's gradient (the JAX loops are manual
        over dp only, ``sp`` left to GSPMD's exact reduction)."""
        if self.sp_group.size() > 1:
            comm.all_reduce(acc, comm.ReduceOp.AVG, self.sp_group, log_name="grad_reduce")

    def _record_grad_reduce_wire(self, divisor):
        """The step's gradient reduction in the comms logger's step record
        (JAX ``_record_grad_reduce_wire``): the analytic wire bytes of the
        collectives this schedule issues (``telemetry/wire.py``), their
        count and the schedule, ``per_microbatch`` or ``deferred``.  qgZ's
        quantized collectives record themselves."""
        from ..telemetry.wire import plain_wire_bytes

        n = self.world
        if n <= 1 or self._qgz:
            return
        if self._onebit:
            if self.step_count < self.config.optimizer.params.freeze_step:
                nbytes = plain_wire_bytes("all_reduce", 4 * self._acc_flat.numel(), n)
                comm.comms_logger.record("grad_reduce_dp", nbytes, n, variant="float32",
                                         schedule="deferred")
            else:
                nbytes = sum(plain_wire_bytes("all_gather", -(-v.numel() // 8) + 4, n)
                             for v in self._acc_views)
                comm.comms_logger.record("onebit_all_reduce", nbytes, n, variant="onebit",
                                         count=2 * len(self._acc_views),
                                         schedule="deferred")
            return
        dtype = self._comm_dtype
        payload = sum(r.padded for r in self.plan.regions) * \
            torch.empty(0, dtype=dtype).element_size()
        issues = divisor if self._per_micro else 1
        per_issue = len(self.plan.regions) if self._per_micro else len(self._buckets)
        if self.plan.stage == 0:
            nbytes = plain_wire_bytes("all_reduce", payload, n)
        else:
            # MiCS: the reduce-scatter over zshard, then the replicas'
            # all-reduce of its 1/zshard over dp
            nbytes = plain_wire_bytes("reduce_scatter", payload, self._parts)
            if self._replica_group is not None:
                nbytes += plain_wire_bytes("all_reduce", payload // self._parts,
                                           self._replica_group.size())
        comm.comms_logger.record(
            "grad_reduce_dp", nbytes * issues, n,
            variant=str(dtype).split(".")[-1], count=issues * per_issue,
            schedule=self._grad_schedule_tag)

    def _reduce_qgz(self, divisor):
        """qgZ (JAX ``_grads_for_batch_qgz``): each parameter's mean over
        microbatches, then its mean over ranks, through the quantized
        all-reduce for parameters of at least ``group_size x world``
        elements and one exact all-reduce for the smaller ones together;
        under ``comm.overlap`` the large ones go through one quantized
        all-reduce a :func:`bucketize` group.  The quantized all-reduce
        runs the two-hop schedule where :attr:`_qgz_intra` names a first
        hop (``comm.quantized.intra_axis``, or ``zshard``), else the flat
        one over the batch group (the ZeRO group at ``sp`` 1; at ``sp`` > 1
        each parameter's exact mean over ``sp`` comes first)."""
        cq = self.config.comm_quantized
        acc = self._acc_flat                 # fp32, the gradient buffer itself
        acc.div_(divisor)
        self._sp_mean(acc)
        group = self.batch_group
        small = [v for v in self._acc_views if v.numel() < cq.group_size * group.size()]
        large = [v for v in self._acc_views if v.numel() >= cq.group_size * group.size()]
        if small:
            for v, r in zip(small, fused_flat_reduce(small, lambda t: comm.all_reduce(
                    t, comm.ReduceOp.AVG, group, log_name="grad_reduce"))):
                v.copy_(r)

        def quantized(t):
            return comm.all_reduce_quantized(
                t, op=comm.ReduceOp.AVG, group=group, intra_group=self._qgz_intra,
                group_size=cq.group_size, impl=cq.impl, wire_dtype=cq.wire_dtype)

        if not self.config.comm_overlap.enabled:
            for v in large:
                v.copy_(quantized(v))
            return
        for b in bucketize([v.numel() * 4 for v in large], self._bucket_mb):
            leaves = [large[i] for i in b]
            for v, r in zip(leaves, fused_flat_reduce(leaves, quantized)):
                v.copy_(r)

    def _partitioned(self):
        return self.plan.stage >= 1 and self._parts > 1

    def _sum_pieces(self, sq, expert):
        """``sq`` [k, ...] (this rank's pieces' sums) summed over the ranks
        that hold the other pieces: the rows of dense parameters over the
        dense partition group, those of expert parameters (``expert``, a
        bool [k]) over theirs and then over ``ep`` (each ``ep`` rank holds
        other experts)."""
        if not self._expert_names:
            if self._partitioned():
                comm.all_reduce(sq, group=self._part_group)
            return sq
        e = expert.reshape((-1,) + (1,) * (sq.dim() - 1)).to(sq.dtype)
        dense, experts = sq * (1 - e), sq * e
        for x, lay in ((dense, self._layouts[False]), (experts, self._layouts[True])):
            if self.plan.stage >= 1 and lay.part.size() > 1:
                comm.all_reduce(x, group=lay.part)
        if self.ep_group.size() > 1:
            comm.all_reduce(experts, group=self.ep_group)
        return dense + experts

    def _sum_whole(self, sq, split, expert=None):
        """Squares summed into whole parameters: ``sq`` [k, ...] holds this
        rank's pieces' sums; the partitions' pieces are summed
        (:meth:`_sum_pieces`, ``expert`` marking the expert rows), then the
        rows of tp-split parameters (``split``, a bool [k]) over ``tp``, the
        whole ones taken once (from tp rank 0)."""
        sq = self._sum_pieces(sq, expert)
        if self.tp_group.size() > 1:
            keep = split | (self.tp_group.rank() == 0)
            sq = sq * keep.reshape((-1,) + (1,) * (sq.dim() - 1)).to(sq.dtype)
            comm.all_reduce(sq, group=self.tp_group)
        return sq

    def _global_sq(self, g, extra=None):
        """The whole gradient's summed squares, [1]: of the local buffer
        where it is whole, else the ranks' squares summed (split and whole
        tp parameters apart, and MoE experts apart: each ``ep`` rank holds
        other experts).  ``extra`` [1], squares of this rank's that the sum
        leaves out (a pipeline's tied replicas), comes off its whole rows
        before the sums over the ranks."""
        if self.tp_group.size() > 1 or self._expert_names:
            kinds = [(s, e) for s in (True, False) for e in (False, True)]
            rows = {k: [] for k in kinds}
            for n, t in self.grads.items():
                rows[(n in self._tp_dims, n in self._expert_names)].append(t)
            sq = torch.stack([torch.stack(torch._foreach_norm(rows[k])).square().sum()
                              if rows[k] else g.new_zeros(()) for k in kinds])
            if extra is not None:
                sq[kinds.index((False, False))] -= extra[0]
            flags = torch.tensor(kinds, device=sq.device)
            return self._sum_whole(sq, flags[:, 0], flags[:, 1]).sum().reshape(1)
        sq = torch.dot(g, g).reshape(1)
        if extra is not None:
            sq = sq - extra
        if self._partitioned():
            comm.all_reduce(sq, group=self._part_group)
        return sq

    def _global_norm(self, g):
        """The L2 norm of the whole gradient (:meth:`_global_sq`)."""
        return torch.sqrt(self._global_sq(g))[0]

    def _whole_sq(self, names, sq):
        """LAMB's whole-parameter squares: ``sq`` [k, 2] holds, for the
        parameters ``names`` this rank has pieces of, its pieces' squared
        norms (of the parameter and its update); returns them summed over
        the pieces and slices of each parameter, in one collective a
        group."""
        row = {n: i for i, n in enumerate(self._order)}
        idx = torch.tensor([row[n] for n in names], device=sq.device)
        full = sq.new_zeros((len(self._order), 2)).index_copy_(0, idx, sq)
        split = torch.tensor([n in self._tp_dims for n in self._order], device=sq.device)
        expert = torch.tensor([n in self._expert_names for n in self._order],
                              device=sq.device)
        return self._sum_whole(full, split, expert).index_select(0, idx)

    def _any_rank(self, flag):
        """A bool scalar, true if it is on any rank holding a partition or
        a tp slice."""
        experts = self._layouts[True].part
        groups = [g for g, on in (
            (self._part_group, self._partitioned()),
            (experts, bool(self._expert_names) and self.plan.stage >= 1
             and experts is not self._part_group and experts.size() > 1),
            (self.ep_group, bool(self._expert_names) and self.ep_group.size() > 1),
            (self.tp_group, self.tp_group.size() > 1)) if on]
        if not groups:
            return flag
        x = flag.to(torch.float32).reshape(1)
        for group in groups:
            comm.all_reduce(x, comm.ReduceOp.MAX, group)
        return x[0] > 0

    @torch.no_grad()
    def _apply(self, lr):
        if self._host_adam is not None:
            self._apply_host(lr)
        elif self._offload:
            self._apply_offloaded(lr)
        else:
            self.opt_state = self._update(self.master_params, self.opt_state, lr)
            self._refresh_compute()

    def _update(self, masters, state, lr):
        """The optimizer's update of ``masters`` (name -> tensor) from the
        gradients; returns the new optimizer state."""
        updates, state = self.tx.update(dict(self.grads), state, masters)
        ups = [updates[n] for n in masters]
        torch._foreach_add_(list(masters.values()), ups,
                            alpha=1.0 if self._updates_include_lr else -lr)
        return state

    def _apply_offloaded(self, lr):
        """The host tiers' update (the JAX engine's ``_materialize_state`` /
        ``_dehydrate_state``): the pinned masters and optimizer state to the
        card, the device update, the compute copy refreshed, both back."""
        clock = time.perf_counter
        self._ensure_opt_resident()
        self._sync()
        t0 = clock()
        copies = DeviceCopies(self.device)
        masters = {n: copies(t) for n, t in self.master_params.items()}
        state = copies.tree(self.opt_state)
        self._sync()
        t1 = clock()
        state = self._update(masters, state, lr)
        self._refresh_compute(copies)
        self.opt_state = copies.host(state)
        self._sync()
        t2 = clock()
        copies.write_back()
        t3 = clock()
        self._spill_opt()
        self.offload_stats = {"h2d_bytes": copies.h2d_bytes, "h2d_s": t1 - t0,
                              "update_s": t2 - t1, "d2h_bytes": copies.d2h_bytes,
                              "d2h_s": t3 - t2, "swap_out_s": clock() - t3}

    def _apply_host(self, lr):
        """The host update (the JAX engine's ``engine.py:1929-1954``): the
        clipped fp32 gradients down in one copy into pinned memory (cast to
        bf16 on the card under ``wire_dtype: "bf16"``), the native Adam over
        the host masters and moments, then the compute copy up."""
        clock = time.perf_counter
        t0 = clock()
        self._sync()                        # the forward and backward passes
        t1 = clock()
        g = self._grad_flat
        self._host_grad.copy_(g.to(self._wire_dtype), non_blocking=True)
        self._sync()
        t2 = clock()
        self._host_adam.step(self.master_params, self._host_grads, lr=lr)
        t3 = clock()
        self._cast_on_host()
        t4 = clock()
        h2d = self._copy_up()
        self._sync()
        t5 = clock()
        self.offload_stats = {
            "device_s": t1 - t0, "d2h_s": t2 - t1,
            "d2h_bytes": g.numel() * self._host_grad.element_size(),
            "adam_s": t3 - t2, "adam_elements": g.numel(), "cast_s": t4 - t3,
            "h2d_s": t5 - t4, "h2d_bytes": h2d}

    def _cast_on_host(self):
        """Host update: each cast region's masters into its pinned staging
        buffer, in the compute type."""
        self._sync()            # an earlier copy up may still read the staging
        for (region, master, _, _), stage in zip(self._compute, self._host_stage):
            if stage is not None:
                stage.copy_(master)

    def _copy_up(self):
        """Host update: the compute copy from the staging buffers (fp32
        regions from the masters); returns the bytes copied."""
        nbytes = 0
        for (region, master, buf, _), stage in zip(self._compute, self._host_stage):
            src = master if stage is None else stage
            buf.copy_(src, non_blocking=True)
            nbytes += src.numel() * src.element_size()
        return nbytes

    def _upload_compute(self):
        """Host update: the compute copy from the host masters, cast on the
        host (the JAX engine's ``_upload_compute``)."""
        self._cast_on_host()
        self._copy_up()

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
        microbatches come from the loader over ``training_data=``.  The
        first step under ``schedule.mode: auto`` also records the
        collectives it issues into :attr:`scheduled_step` and, under
        ``memory: auto`` at stage 3, its gathers into :attr:`memory_plan`."""
        step = self.scheduled_step
        if step is None or step.published:
            return self._train_batch(data_iter, batch)
        from ..comm import schedule

        recorder = schedule.SiteRecorder()
        plan_memory = self._memory_mode == "auto" and self.config.zero_stage == 3
        if plan_memory:
            self._gather_ledger.events = []
        if self._hooks is not None:
            self._hooks.recorder = recorder
        try:
            with schedule.record_sites(recorder):
                loss = self._train_batch(data_iter, batch)
        finally:
            if self._hooks is not None:
                self._hooks.recorder = None
            events, self._gather_ledger.events = self._gather_ledger.events, None
        step.publish(recorder.sites)
        if plan_memory:
            self._publish_memory_plan(events)
        return loss

    def _publish_memory_plan(self, events):
        """The stage-3 movement plan from the first step's gathers and
        releases (the JAX engine's ``_publish_memory_plan``): analysis only,
        the gathers stay where they are."""
        from ..comm.memplan import movement_summary, plan_param_movement

        self.memory_plan = self.scheduled_step.move_sites = tuple(plan_param_movement(events))
        summ = movement_summary(self.memory_plan)
        log_dist("comm.memplan[auto]: zero-3 movement plan -- "
                 f"{summ['n_sites']} gather/release sites, "
                 f"{summ['gathered_bytes'] / 2**20:.1f} MiB gathered, "
                 f"peak live {summ['peak_live_bytes'] / 2**20:.1f} MiB, "
                 f"mean span {summ['mean_live_span']:.1f} events", ranks=[0])

    def _train_batch(self, data_iter, batch):
        if data_iter is None and batch is None:
            if self._data_iterator is None:
                raise ValueError("no data: pass data_iter/batch or training_data")
            data_iter = self._data_iterator   # persistent: keeps advancing epochs
        local = data_iter is self._data_iterator and data_iter is not None
        data = batch if batch is not None else data_iter
        if local and batch is None and self._prefetch_depth > 0:
            # the persistent loader, wrapped once: the next steps' batches
            # go to the device while this one runs
            if self._prefetcher is None:
                from .dataloader import DevicePrefetchingLoader

                dl = self.training_dataloader
                self._prefetcher = DevicePrefetchingLoader(
                    data_iter, self.device, depth=self._prefetch_depth,
                    position_fn=getattr(dl, "state_dict", None),
                    pulls_per_batch=self.gradient_accumulation_steps())
            micro = next(self._prefetcher)
        else:
            micro = self._stack_microbatches(data, local)
        micro, ltd = self._apply_data_efficiency(micro)
        micro = self._seq_local(micro)
        if self._opt_swapper is not None:
            # the NVMe tier's reads run while the card computes the gradients
            self._opt_swapper.prefetch()
        scale = self._scale()
        self._acc_count = 0
        weights = self._mask_weights(micro)
        losses = []
        for i, mb in enumerate(micro):
            loss = self._micro_loss(mb, ltd)
            if weights is not None:
                loss = loss * weights[i]
            self._accumulate(loss, scale, last=i == len(micro) - 1, divisor=len(micro))
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
        micro = self._seq_local(self._stack_microbatches(data))
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
        mb = self._seq_local([self._to_device(self._local(batch))])[0]
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
            self._reset_volatile()
            return load_dir, meta.get("client_state", {})
        from .checkpointing import load_checkpoint

        out = load_checkpoint(self, load_dir, tag=tag,
                              load_optimizer_states=load_optimizer_states,
                              load_module_only=load_module_only,
                              load_module_strict=load_module_strict)
        self._reset_volatile()
        return out

    def _reset_volatile(self):
        """What a checkpoint does not hold starts again from zero after a
        load: 1-bit Adam's error feedback (as in the JAX engine)."""
        if self._onebit_error is not None:
            self._onebit_error.zero_()

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
