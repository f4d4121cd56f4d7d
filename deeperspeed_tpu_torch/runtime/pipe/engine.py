"""Pipeline engine (counterpart of ``deeperspeed_tpu/runtime/pipe/engine.py``
and of the contract of its compiled schedules, ``compiled.py`` and
``compiled_1f1b.py``).

One process a pipeline stage (and a data-parallel replica): the mesh's
``pp`` axis is outermost, so stage ``s`` of replica ``d`` is the process
whose ``pp`` coordinate is ``s``.  Each process holds only its own stage's
module (``build_stage`` of a stage model: the embedding on the first stage,
the head on the last) and walks its stage's instruction stream
(``schedule.py``): ``pipeline.schedule`` ``1f1b`` (``TrainSchedule``) or
``gpipe`` (``GPipeSchedule``).  Activations go forward and their gradients
come back by point-to-point sends and receives over the ``pp`` group
(``comm.isend`` / ``comm.irecv``; on gloo staged through host memory);
each batch's first activation is preceded by a small shape message, so the
stages agree on the shape of every batch (curriculum truncation included).
A send is issued when its instruction comes; the previous send to the same
stage is waited for first (one send in flight a link, deadlock-free for
these streams), the rest at the end of the stream; a receive is waited
for at once.

The contract the JAX package's compiled pipelines keep, kept here:

* the loss is the mean over microbatches of each microbatch's masked mean
  (the last stage computes it; every rank of ``train_batch`` returns it);
* each microbatch's backward is seeded with the loss scale (1 outside
  fp16) and the sum over microbatches is divided by their count, the
  flat engine's ``scale / M``;
* a stage keeps only each in-flight microbatch's stage *input* and
  recomputes the stage's forward in its backward, so under ``1f1b`` at most
  ``S - s`` microbatches are live at stage ``s`` and under ``gpipe`` all
  ``M`` (:meth:`peak_live_inputs`); the last stage's forward instruction is
  folded into its backward, which runs the forward and the loss anyway.

Each stage is a flat engine over its own parameters (``runtime/engine.py``):
the fp32 masters, ZeRO 0-2 over the stage's data-parallel group, the
optimizer, fp16 loss scaling, and ``offload_optimizer``: the host update
(ZeRO-0) or the pinned-host and NVMe tiers of the optimizer state, each
stage process over its own stage.  Under ``tp`` (pp x tp, GPT-NeoX's 3-D
layout) a stage's blocks, its vocabulary-parallel embedding and head split
over the stage's tp group as the flat model splits
(``PipeStage.param_partition_rules``); stage ``s``'s tp rank ``t`` sends to
stage ``s + 1``'s tp rank ``t`` (the activation is whole after the
row-parallel reduce, so each tp rank sends its copy).  The global gradient
norm (the clip) sums the squares over the tp ranks (split parameters'
slices; whole ones once), the partitions and the ``pp`` group, and an fp16
overflow on any stage skips the step on every stage.  Refused, as in the
JAX package: ZeRO stage 3, progressive layer drop, random-LTD,
compression, and the micro-level ``forward`` / ``backward`` / ``step``;
and what the reference does not run: qgZ and 1-bit Adam over a pipeline
(the JAX ``PipelineEngine`` fails on both) and
``comm.overlap.schedule.mode: auto`` over one (it waits for a reference
whose own ``auto`` path runs).

Checkpoints are the flat engine's files with the JAX ``PipelineEngine``'s
parameter tree, ``{embed, stages, head}`` with stacked ``stages`` leaves
(the stage module gathers it over ``pp``, the engine joins the tp slices),
so either package and any ``pp`` and ``tp`` loads them.
"""

import math
import time

import torch

from ... import comm
from ...parallel import topology as topo
from ...utils.logging import log_dist
from ..config import DeeperSpeedConfig, pipe_auto_refusal, pipe_compressed_refusal
from ..engine import DeeperSpeedEngine
from . import schedule as sched
from .module import PipelineModule

_MICRO_API = ("Only train_batch() and eval_batch() are accessible on a pipeline "
              "engine (reference pipe/engine.py contract)")
# the dtypes a shape message names, by index
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.uint8, torch.bool)
_META = 10          # int64 entries of a shape message: ndim, dtype, dims


class PipelineError(RuntimeError):
    pass


def _unused_loss(model, batch, rng=None, **_):
    raise PipelineError("a pipeline stage computes its loss inside its schedule")


class PipelineEngine(DeeperSpeedEngine):
    """Trains a stage model (``GPTNeoXPipe``, ``LlamaPipe``) or a
    ``PipelineModule`` of GPT-NeoX / Llama blocks with ``train_batch``;
    ``eval_batch`` runs ``InferenceSchedule``."""

    def __init__(self, model, config, optimizer=None, model_parameters=None,
                 loss_fn=None, training_data=None, collate_fn=None,
                 lr_scheduler=None, device=None):
        mesh = topo.get_mesh()
        if not isinstance(config, DeeperSpeedConfig):
            config = DeeperSpeedConfig(config, world_size=mesh.data_parallel_size)
        self.pipe_group = comm.get_pipe_parallel_group()
        self.stage_id = self.pipe_group.rank()
        stage = self._stage_module(model, mesh, config, device)
        self.num_stages = mesh.pp
        self._check(config, mesh)
        if model_parameters is not None:
            stage.load_state_dict(model_parameters)
        super().__init__(model=stage, config=config, optimizer=optimizer,
                         loss_fn=_unused_loss, training_data=training_data,
                         collate_fn=collate_fn, lr_scheduler=lr_scheduler,
                         device=device)
        if self.progressive_layer_drop is not None:
            raise NotImplementedError(
                "progressive_layer_drop is not supported on the compiled "
                "pipeline path")
        if self.random_ltd_scheduler is not None:
            raise NotImplementedError(
                "random-LTD is not supported on the compiled pipeline path")
        self.micro_batches = self.gradient_accumulation_steps()
        self.is_first = self.stage_id == 0
        self.is_last = self.stage_id == self.num_stages - 1
        self._dropout = any(getattr(self.module.config, k, 0.0) > 0.0
                            for k in ("hidden_dropout", "attention_dropout")) \
            if hasattr(self.module, "config") else False
        # the step's split (train_batch): host seconds in the stage's
        # compute, in sends and receives, and the messages and bytes moved;
        # ``pipe_timing`` synchronizes the card after each compute
        # instruction so that its seconds are the device's, and records the
        # peak memory of the forward and backward instructions (before the
        # optimizer step; the card's peak statistics are reset for it)
        self.pipe_timing = False
        self.pipe_stats = {}
        self._peak_live = 0
        log_dist(f"{type(self).__name__}: {self.num_stages} stages, stage "
                 f"{self.stage_id} of this rank, {self.micro_batches} microbatches, "
                 f"schedule {config.pipeline.schedule}", ranks=[0])

    # ------------------------------------------------------------ building
    def _stage_module(self, model, mesh, config, device):
        if isinstance(model, PipelineModule):
            model = _pipe_module_to_stage_model(model)
        if not hasattr(model, "build_stage"):
            raise PipelineError(
                "PipelineEngine needs a stage model (e.g. models.GPTNeoXPipe) "
                "or a PipelineModule of homogeneous transformer blocks")
        if mesh.pp != model.num_stages:
            raise PipelineError(
                f"mesh pp={mesh.pp} != model stages={model.num_stages}; set "
                f"config mesh.pipe_parallel_size to match")
        return model.build_stage(self.stage_id, device)

    def _check(self, config, mesh):
        """The configurations the pipeline engines refuse."""
        if config.pipeline.schedule not in ("1f1b", "gpipe"):
            # a typo must not silently select the wrong memory profile
            raise PipelineError(
                f"pipeline.schedule={config.pipeline.schedule!r} is not "
                f"one of ('1f1b', 'gpipe')")
        if config.zero_stage >= 3:
            raise NotImplementedError(
                "ZeRO-3 does not compose with the interpreted 1F1B pipeline "
                "(per-microbatch param gathers would serialize the "
                "interleave); use stage <= 2 here, or the flat engine for "
                "stage 3 (the reference likewise restricts PP to stage <= 2)")
        opt = (config.optimizer.type.lower() if config.optimizer is not None else "")
        if (config.comm_quantized.enabled or config.zero_quantized_gradients
                or opt == "onebitadam"):
            raise pipe_compressed_refusal()
        if config.comm_overlap.enabled and config.comm_overlap.schedule.mode == "auto":
            raise pipe_auto_refusal()

    def _update_processes(self):
        """A stage's processes: the host update runs on each stage alone."""
        return comm.get_world_size() // self.num_stages

    # ------------------------------------------------ the reference API
    def forward(self, *args, **kwargs):
        raise PipelineError(_MICRO_API)

    __call__ = forward

    def backward(self, *args, **kwargs):
        raise PipelineError(_MICRO_API)

    def step(self, *args, **kwargs):
        raise PipelineError(_MICRO_API)

    def is_first_stage(self):
        return self.is_first

    def is_last_stage(self):
        return self.is_last

    def set_dataiterator(self, iterator):
        self._data_iterator = iterator

    def peak_live_inputs(self):
        """The most microbatch inputs this stage held at once during the
        last ``train_batch`` (1F1B: at most ``S - s``; GPipe: ``M``)."""
        return self._peak_live

    # ------------------------------------------------------------ transport
    def _send(self, t, peer):
        """Issue a send of ``t`` to stage ``peer`` once the previous one to it
        has completed."""
        previous = self._sends_pending.pop(peer, None)
        if previous is not None:
            previous.wait()
        self._sends_pending[peer] = comm.isend(t.detach(), peer, self.pipe_group)
        self._count_p2p(t)

    def _recv(self, peer, shape, dtype):
        t = torch.empty(shape, dtype=dtype, device=self.device)
        comm.recv(t, peer, self.pipe_group)
        self._count_p2p(t)
        return t

    def _count_p2p(self, t):
        self._p2p_msgs += 1
        self._p2p_bytes += t.numel() * t.element_size()

    def _send_meta(self, t, peer):
        meta = torch.zeros(_META, dtype=torch.int64)
        meta[0], meta[1] = t.dim(), _DTYPES.index(t.dtype)
        meta[2:2 + t.dim()] = torch.tensor(t.shape)
        self._send(meta.to(self.device), peer)

    def _recv_meta(self, peer):
        meta = self._recv(peer, (_META,), torch.int64).tolist()
        return tuple(meta[2:2 + meta[0]]), _DTYPES[meta[1]]

    # ------------------------------------------------------------- the data
    def _microbatches(self, data_iter, batch):
        """This rank's rows of the gas global microbatches, on the device,
        after the curriculum's truncation."""
        local = False
        if batch is None and data_iter is None:
            if self._data_iterator is None:
                raise ValueError("no data: pass data_iter/batch or training_data")
            data_iter, local = self._data_iterator, True
        micro = self._stack_microbatches(batch if batch is not None else data_iter, local)
        micro, _ = self._apply_data_efficiency(micro)
        return self._seq_local(micro)

    def _schedule(self, train):
        M, S, s = self.micro_batches, self.num_stages, self.stage_id
        if not train:
            return sched.InferenceSchedule(M, S, s)
        cls = sched.TrainSchedule if self.config.pipeline.schedule == "1f1b" \
            else sched.GPipeSchedule
        return cls(M, S, s)

    # ------------------------------------------------------------- the step
    def _train_batch(self, data_iter, batch):
        t_step = time.perf_counter()
        micro = self._microbatches(data_iter, batch)
        self._acc_count = 0
        losses = self._run(self._schedule(train=True), micro, train=True)
        loss = self._gather_loss(losses, micro, bcast=True)
        self.micro_steps += len(micro)
        metrics = self._step_metrics
        self._report({"loss": loss, **metrics})
        self.pipe_stats["step_s"] = time.perf_counter() - t_step
        return loss

    def _gather_loss(self, losses, micro, bcast):
        """The last stage's mean over its microbatches' losses, averaged over
        its data-parallel group; broadcast to every stage (``bcast``), or
        None off the last stage."""
        if self.is_last:
            loss = torch.stack(losses).mean()
            if self.world > 1:
                comm.all_reduce(loss.reshape(1), comm.ReduceOp.AVG, self.group)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
        if bcast and self.num_stages > 1:
            comm.broadcast(loss.reshape(1), self.num_stages - 1, self.pipe_group)
        return loss if (bcast or self.is_last) else None

    def _run(self, schedule, micro, train, compute_loss=True):
        """Walk this stage's instruction stream over the microbatches
        ``micro``; returns the last stage's losses (weighted as the flat
        engine weights a masked mean over its data-parallel ranks), or
        without ``compute_loss`` (evaluation) its outputs."""
        prev, nxt = self.stage_id - 1, self.stage_id + 1
        M = len(micro)
        weights = self._mask_weights(micro) if self.is_last else None
        scale = self._scale()
        sync = self.pipe_timing and self.device.type == "cuda"
        clock = time.perf_counter
        inputs, outbox, gradbox, shapes, rng_states = {}, {}, {}, {}, {}
        n = dict.fromkeys(("load", "recv_act", "fwd", "send_act", "recv_grad", "bwd",
                           "send_grad"), 0)
        losses, in_meta = [], None
        self._sends_pending = {}
        self._p2p_msgs = self._p2p_bytes = 0
        if sync:
            torch.cuda.reset_peak_memory_stats(self.device)
        compute_s = p2p_s = 0.0
        live = self._peak_live = 0
        self._step_metrics = None
        for step in schedule:
            for cmd in step:
                t0 = clock()
                if isinstance(cmd, sched.LoadMicroBatch):
                    mb = n["load"]
                    n["load"] += 1
                    if self.is_first:
                        inputs[mb] = self.module.stage_input(micro[mb])
                        live += 1
                elif isinstance(cmd, sched.RecvActivation):
                    mb = n["recv_act"]
                    n["recv_act"] += 1
                    if in_meta is None:
                        in_meta = self._recv_meta(prev)
                        x = torch.empty(0, dtype=in_meta[1])
                        self._act = (math.prod(in_meta[0]) * x.element_size(),
                                     str(in_meta[1])[6:])
                    inputs[mb] = self._recv(prev, *in_meta)
                    live += 1
                    p2p_s += clock() - t0
                elif isinstance(cmd, sched.ForwardPass):
                    mb = n["fwd"]
                    n["fwd"] += 1
                    if self.is_last and train:
                        continue    # the backward runs the forward and the loss
                    if self._dropout and train:
                        rng_states[mb] = self._rng.get_state()
                    with torch.no_grad():
                        y = self.module.forward_stage(inputs[mb], micro[mb],
                                                   self._rng if train else None)
                        if self.is_last:
                            del inputs[mb]
                            live -= 1
                            if compute_loss:
                                losses.append(self._weighted(
                                    self.module.stage_loss(y, micro[mb]), weights, mb))
                            else:
                                losses.append(self.module.stage_output(y))
                        else:
                            outbox[mb] = y
                            shapes[mb] = (tuple(y.shape), y.dtype)
                            if not train:
                                del inputs[mb]
                                live -= 1
                    if sync:
                        torch.cuda.synchronize(self.device)
                    compute_s += clock() - t0
                elif isinstance(cmd, sched.SendActivation):
                    mb = n["send_act"]
                    n["send_act"] += 1
                    y = outbox.pop(mb)
                    if mb == 0:
                        self._send_meta(y, nxt)
                        self._act = (y.numel() * y.element_size(), str(y.dtype)[6:])
                    self._send(y, nxt)
                    p2p_s += clock() - t0
                elif isinstance(cmd, sched.RecvGrad):
                    mb = n["recv_grad"]
                    n["recv_grad"] += 1
                    gradbox[mb] = self._recv(nxt, *shapes.pop(mb))
                    p2p_s += clock() - t0
                elif isinstance(cmd, sched.BackwardPass):
                    mb = n["bwd"]
                    n["bwd"] += 1
                    losses.append(self._backward(mb, inputs.pop(mb), micro[mb],
                                                 gradbox.pop(mb, None), rng_states.pop(mb, None),
                                                 weights, scale, M))
                    live -= 1
                    if sync:
                        torch.cuda.synchronize(self.device)
                    compute_s += clock() - t0
                elif isinstance(cmd, sched.SendGrad):
                    mb = n["send_grad"]
                    n["send_grad"] += 1
                    self._send(self._input_grads.pop(mb), prev)
                    p2p_s += clock() - t0
                elif isinstance(cmd, sched.OptimizerStep):
                    t1 = clock()
                    self._wait_sends()
                    p2p_s += clock() - t1
                    if sync:
                        stream_peak = torch.cuda.max_memory_allocated(self.device)
                    self._step_metrics = self._finish_step(M)
                # ReduceTiedGrads and ReduceGrads: the tie's and the
                # data-parallel reductions run in _finish_step's
                # _reduce_gradients
                self._peak_live = max(self._peak_live, live)
        t1 = clock()
        self._wait_sends()
        p2p_s += clock() - t1
        self.pipe_stats = {"compute_s": compute_s, "p2p_s": p2p_s,
                           "p2p_msgs": self._p2p_msgs, "p2p_bytes": self._p2p_bytes}
        if sync and train:
            self.pipe_stats["stream_peak_bytes"] = stream_peak
        return losses

    def _weighted(self, loss, weights, mb):
        return loss if weights is None else loss * weights[mb]

    def _wait_sends(self):
        for h in self._sends_pending.values():
            h.wait()
        self._sends_pending = {}

    def _backward(self, mb, x, batch, dy, rng_state, weights, scale, M):
        """Recompute the stage's forward on its saved input ``x`` and run its
        backward: the last stage from its (weighted) loss times the loss
        scale, the others from the received cotangent ``dy``.  The input's
        gradient waits in ``_input_grads`` for its send; returns the
        detached loss (None off the last stage)."""
        if mb == 0:
            self._input_grads = {}
        if not self.is_first and x.is_floating_point():
            x = x.detach().requires_grad_(True)
        if rng_state is not None:
            # replay the forward's dropout draws, then go on from where the
            # generator was
            resume = self._rng.get_state()
            self._rng.set_state(rng_state)
        y = self.module.forward_stage(x, batch, self._rng)
        if rng_state is not None:
            self._rng.set_state(resume)
        last = mb == M - 1
        out = None
        if self.is_last:
            loss = self._weighted(self.module.stage_loss(y, batch), weights, mb)
            self._accumulate(loss, scale, last=last, divisor=M)
            out = loss.detach().to(torch.float32)
        else:
            self._accumulate(y, None, last=last, divisor=M, grad=dy.to(y.dtype))
        if not self.is_first:
            self._input_grads[mb] = (x.grad if x.grad is not None else torch.zeros_like(x))
        return out

    # --------------------------------------------- the stage-wide reductions
    def _record_grad_reduce_wire(self, divisor):
        """The flat engine's record of the gradient reduction, plus the
        pipeline's analytic P2P bytes (the JAX ``_record_pipe_wire``): per
        batch ``2 (M + S - 1)`` messages of one activation of this rank's
        rows (``B S H itemsize`` for a transformer).  Under ``tp`` each tp
        rank sends its copy of the whole activation; the record counts it
        once, on tp rank 0, as the norm counts a whole parameter once, so
        that the records summed over the ranks are the JAX mesh's."""
        super()._record_grad_reduce_wire(divisor)
        S = self.num_stages
        act = getattr(self, "_act", None)
        if (S > 1 and act is not None and comm.comms_logger._capturing
                and self.tp_group.rank() == 0):
            nbytes, name = act
            ticks = divisor + S - 1
            comm.comms_logger.record("pipe_ppermute", 2.0 * ticks * nbytes, S,
                                     variant=name, count=2 * ticks)

    def _global_norm(self, g):
        """The L2 norm of the whole model's gradient: this stage's squares
        (:meth:`_global_sq`, over its partitions and tp ranks) summed over
        the ``pp`` group, a tied weight's replicas counted once."""
        sq = self._global_sq(g, self._replica_sq())
        if self.num_stages > 1:
            comm.all_reduce(sq, group=self.pipe_group)
        return torch.sqrt(sq.clamp(min=0.0))[0]

    def _replica_sq(self):
        """The squares of this stage's pieces of tied-weight replicas (the
        interpreted engine's), which the norm leaves out."""
        return None

    def _any_rank(self, flag):
        """An fp16 overflow on any stage skips the step on every stage."""
        flag = super()._any_rank(flag)
        if self.num_stages == 1:
            return flag
        x = flag.to(torch.float32).reshape(1)
        comm.all_reduce(x, comm.ReduceOp.MAX, self.pipe_group)
        return x[0] > 0

    # ------------------------------------------------------------ evaluation
    @torch.no_grad()
    def eval_batch(self, data_iter=None, batch=None, compute_loss=True, bcast_loss=True):
        """Forward-only pipelined evaluation over ``InferenceSchedule``
        (deterministic).  With ``compute_loss`` the mean loss of the last
        stage, broadcast to every rank (``bcast_loss``; else None off the
        last stage); without it the last stage's outputs, concatenated
        along the rows (None elsewhere)."""
        micro = self._seq_local(self._stack_microbatches(
            batch if batch is not None else data_iter))
        out = self._run(self._schedule(train=False), micro, train=False,
                        compute_loss=compute_loss)
        if not compute_loss:
            return torch.cat(out) if self.is_last else None
        return self._gather_loss(out, micro, bcast=bcast_loss)


def _pipe_module_to_stage_model(pipe_module):
    """A ``PipelineModule`` made solely of GPT-NeoX or Llama block
    ``LayerSpec``s as the stage model of its family (the JAX package's
    conversion and refusals)."""
    from ...models.gpt_neox_pipe import GPTNeoXPipe
    from ...models.llama_pipe import LlamaPipe

    specs = pipe_module.specs
    block_cfgs = []
    for spec in specs:
        cfg = getattr(spec, "module_kwargs", {}).get("config") or (
            spec.module_args[0] if getattr(spec, "module_args", None) else None)
        if cfg is not None and type(cfg).__name__ in ("GPTNeoXConfig", "LlamaConfig"):
            block_cfgs.append(cfg)
    if not block_cfgs or len(block_cfgs) != len(specs):
        raise PipelineError(
            "compiled pipeline requires a PipelineModule made solely of "
            "GPT-NeoX-family or Llama-family block LayerSpecs; construct "
            "models.GPTNeoXPipe/LlamaPipe(config, num_stages) directly, or "
            "use pipeline.executor='interpreted' for heterogeneous graphs")
    blk_cfg = block_cfgs[0]
    if any(c is not blk_cfg and c != blk_cfg for c in block_cfgs):
        raise PipelineError("PipelineModule block specs carry differing configs")
    if len(block_cfgs) != blk_cfg.num_layers:
        raise PipelineError(
            f"PipelineModule has {len(block_cfgs)} block specs but the config "
            f"says num_layers={blk_cfg.num_layers}; the compiled pipeline "
            f"builds from the config -- make them agree (e.g. "
            f"dataclasses.replace(cfg, num_layers={len(block_cfgs)}))")
    family = LlamaPipe if type(blk_cfg).__name__ == "LlamaConfig" else GPTNeoXPipe
    return family(blk_cfg, pipe_module.num_stages, seed=pipe_module.base_seed)
