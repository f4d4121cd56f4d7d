"""DeeperSpeedEngine: the training engine, ZeRO-0 on one device
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

Two ways to drive it share that code: ``train_batch`` (a whole step over
gas microbatches, from ``batch=``, ``data_iter=`` or, without arguments,
the loader built from ``training_data=``), and the legacy
``forward`` / ``backward`` / ``step`` (one microbatch at a time); both
accumulate through :meth:`_accumulate` and finish through
:meth:`_finish_step`, so they give the same bits.

Training draws its randomness (dropout, progressive layer drop, random-LTD)
from one ``torch.Generator`` on the engine's device seeded from
``config.seed``; evaluation draws none.  The data-efficiency stack
(curriculum seqlen truncation, progressive layer drop, random-LTD) runs on
the host between steps, as in the JAX engine.

The loss function is ``loss(model, batch, rng)`` (the model's
``loss_fn()``, or ``loss_fn=``): ``rng`` is the generator in training and
None in evaluation.

Not ported yet (raising ``NotImplementedError``): ZeRO stages above 0 and
several processes, checkpoints, the prefetching loader, eigenvalue,
compression and the step telemetry.
"""

import re

import numpy as np
import torch

from ..accelerator import resolve_device
from ..utils.logging import log_dist, logger
from ..utils.tree import tree_global_norm
from .config import DeeperSpeedConfig
from .lr_schedules import get_lr_schedule_fn
from .optimizers import build_optimizer, identity
from .precision import (
    MixedPrecisionPolicy,
    has_inf_or_nan,
    init_loss_scale,
    update_loss_scale,
)


class DeeperSpeedEngine:
    def __init__(self, model, config, optimizer=None, model_parameters=None,
                 loss_fn=None, training_data=None, collate_fn=None,
                 lr_scheduler=None, device=None):
        if not isinstance(config, DeeperSpeedConfig):
            config = DeeperSpeedConfig(config)
        self.config = config
        self.device = resolve_device(device)

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

        self.precision = MixedPrecisionPolicy(config)
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
        self._rng.manual_seed(config.seed)
        self.step_count = 0          # optimizer steps taken (skips excluded)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._last_metrics = {}
        self._acc_count = 0          # microbatches in the accumulation buffer
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

    # ------------------------------------------------------------------ state
    def _build_state(self):
        named = dict(self.module.named_parameters())
        patterns = (self.module.no_cast_paths()
                    if hasattr(self.module, "no_cast_paths")
                    else [r"embed_in\.weight"])
        cast = [n for n, p in named.items()
                if self.precision.compute_dtype(
                    p, any(re.search(pat, n) for pat in patterns)) != torch.float32]
        kept = [n for n in named if n not in set(cast)]
        self._order = cast + kept
        sizes = [named[n].numel() for n in self._order]
        total = sum(sizes)
        n_cast = sum(sizes[:len(cast)])

        self._master_flat = torch.empty(total, dtype=torch.float32, device=self.device)
        self._grad_flat = torch.zeros(total, dtype=torch.float32, device=self.device)
        accum = self.precision.accum_dtype
        self._acc_flat = (self._grad_flat if accum == torch.float32 else
                          torch.zeros(total, dtype=accum, device=self.device))
        self._compute_flat = torch.empty(n_cast, dtype=self.precision.param_dtype,
                                         device=self.device)
        self.master_params, self.grads = {}, {}
        self._acc_views = []
        off = 0
        with torch.no_grad():
            for n, size in zip(self._order, sizes):
                p = named[n]
                view = self._master_flat[off:off + size].view(p.shape)
                view.copy_(p.detach())
                self.master_params[n] = view
                self.grads[n] = self._grad_flat[off:off + size].view(p.shape)
                self._acc_views.append(self._acc_flat[off:off + size].view(p.shape))
                p.data = (self._compute_flat[off:off + size].view(p.shape)
                          if off < n_cast else view)
                off += size
        self._params = [named[n] for n in self._order]
        self._n_cast = n_cast
        self._refresh_compute()

    @torch.no_grad()
    def _refresh_compute(self):
        """The compute copy from the masters: one cast copy (the JAX
        engine's ``cast_for_compute``)."""
        if self._n_cast:
            self._compute_flat.copy_(self._master_flat[:self._n_cast])

    # ------------------------------------------------------------------ data
    def _to_device(self, mb):
        return {k: torch.as_tensor(v).to(self.device) for k, v in mb.items()}

    def _stack_microbatches(self, data):
        """gas microbatch dicts from a full batch dict (split along rows), a
        list/tuple of gas microbatches, or an iterator yielding them."""
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
        return [self._to_device(m) for m in micro]

    def deepspeed_io(self, dataset, batch_size=None, data_sampler=None, collate_fn=None):
        """The engine's loader over ``dataset``: microbatches of
        ``train_micro_batch_size_per_gpu`` rows, shuffled from
        ``config.seed``; with ``data_efficiency.data_sampling`` enabled, drawn
        by the curriculum sampler from a metric-sorted order (JAX engine
        ``deepspeed_io``)."""
        from .dataloader import DeeperSpeedDataLoader

        bs = batch_size or self.train_micro_batch_size_per_gpu()
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
                                     sampler=data_sampler)

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
        accumulation buffer."""
        (loss if scale is None else loss * scale).to(torch.float32).backward()
        accum = self.precision.accum_dtype
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

    def _micro_loss(self, mb, ltd=None):
        for p in self._params:
            p.grad = None
        if ltd is None:
            return self._loss_fn(self.module, mb, self._rng)
        return self._loss_fn(self.module, mb, self._rng, random_ltd_tokens=ltd)

    def _scale(self):
        return self.loss_scale_state.scale if self.precision.is_fp16 else None

    def _finish_step(self, divisor):
        """Mean gradients (the accumulated sum over ``divisor``, in the
        accumulation type), unscale, overflow check, global norm, clip,
        update and loss-scale update: the JAX engine's train step after its
        microbatch scan, and its ``_make_apply``."""
        g = self._grad_flat
        with torch.no_grad():
            self._acc_flat.div_(divisor)
            if self._acc_flat is not g:
                g.copy_(self._acc_flat)
            fp16 = self.precision.is_fp16
            if fp16:
                g.mul_(1.0 / self.loss_scale_state.scale)
            overflow = has_inf_or_nan([g]) if fp16 else None
            grad_norm = tree_global_norm([g])
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
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self.skipped_steps += int(skipped)
        return {"grad_norm": grad_norm, "lr": lr, "overflow": skipped,
                "loss_scale": self.loss_scale_state.scale}

    @torch.no_grad()
    def _apply(self, lr):
        updates, self.opt_state = self.tx.update(dict(self.grads), self.opt_state,
                                                 self.master_params)
        masters = [self.master_params[n] for n in self._order]
        ups = [updates[n] for n in self._order]
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
        data = batch if batch is not None else data_iter
        micro, ltd = self._apply_data_efficiency(self._stack_microbatches(data))
        scale = self._scale()
        self._acc_count = 0
        losses = []
        for mb in micro:
            loss = self._micro_loss(mb, ltd)
            self._accumulate(loss, scale)
            losses.append(loss.detach().to(torch.float32))
        loss = torch.stack(losses).mean()
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
        return torch.stack([self._loss_fn(self.module, mb, None).to(torch.float32)
                            for mb in micro]).mean()

    # -- legacy fwd/bwd/step API (reference ``engine.py:1775,1916,2114``)
    def forward(self, batch):
        """The loss of one microbatch, its graph kept for :meth:`backward`."""
        self._cached_loss = self._micro_loss(self._to_device(batch))
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

    def allreduce_gradients(self, bucket_size=None):
        """No-op: one device holds every gradient."""

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
        return False

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
