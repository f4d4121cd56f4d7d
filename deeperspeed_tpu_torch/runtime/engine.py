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
* each microbatch's gradients are added in fp32 into one flat buffer and
  divided by the accumulation count, so the norm, the clip and the
  overflow scan are one pass each;
* fp16 skips the update of a step whose gradients overflow and backs the
  loss scale off (``precision.py``).

Not ported yet (raising ``NotImplementedError``): ZeRO stages above 0 and
several processes, the dataloader, checkpoints, and the legacy
``forward/backward/step`` API.
"""

import re

import torch

from ..accelerator import resolve_device
from ..utils.logging import log_dist
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


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue A, '{item}')")


class DeeperSpeedEngine:
    def __init__(self, model, config, optimizer=None, model_parameters=None,
                 loss_fn=None, training_data=None, lr_scheduler=None,
                 device=None):
        if training_data is not None:
            raise _not_ported("the dataloader (training_data=)",
                              "Training leftovers")
        if not isinstance(config, DeeperSpeedConfig):
            config = DeeperSpeedConfig(config)
        self.config = config
        self.device = resolve_device(device)
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
        self.training_dataloader = None
        self.step_count = 0          # optimizer steps taken (skips excluded)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._last_metrics = {}

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
        self._compute_flat = torch.empty(n_cast, dtype=self.precision.param_dtype,
                                         device=self.device)
        self.master_params, self.grads = {}, {}
        off = 0
        with torch.no_grad():
            for n, size in zip(self._order, sizes):
                p = named[n]
                view = self._master_flat[off:off + size].view(p.shape)
                view.copy_(p.detach())
                self.master_params[n] = view
                self.grads[n] = self._grad_flat[off:off + size].view(p.shape)
                p.data = (self._compute_flat[off:off + size].view(p.shape)
                          if off < n_cast else view)
                off += size
        self._params = [named[n] for n in self._order]
        self._grad_views = [self.grads[n] for n in self._order]
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

    # ------------------------------------------------------------- the step
    def _accumulate_grads(self, micro, scale):
        """Mean-loss gradients (still multiplied by ``scale``) over the
        microbatches, in fp32, into the flat gradient buffer."""
        self._grad_flat.zero_()
        losses = []
        for mb in micro:
            for p in self._params:
                p.grad = None
            loss = self._loss_fn(self.module, mb)
            (loss if scale is None else loss * scale).to(torch.float32).backward()
            torch._foreach_add_(self._grad_views, [p.grad for p in self._params])
            losses.append(loss.detach().to(torch.float32))
        for p in self._params:
            p.grad = None
        self._grad_flat.div_(len(micro))
        return torch.stack(losses).mean()

    @torch.no_grad()
    def _apply(self, lr):
        updates, self.opt_state = self.tx.update(dict(self.grads), self.opt_state,
                                                 self.master_params)
        masters = [self.master_params[n] for n in self._order]
        ups = [updates[n] for n in self._order]
        torch._foreach_add_(masters, ups, alpha=1.0 if self._updates_include_lr else -lr)
        self._refresh_compute()

    def train_batch(self, data_iter=None, batch=None):
        """One full training step over gas microbatches; returns the mean
        loss as a device scalar (no host sync)."""
        data = batch if batch is not None else data_iter
        if data is None:
            raise ValueError("no data: pass data_iter= or batch=")
        micro = self._stack_microbatches(data)
        fp16 = self.precision.is_fp16
        scale = self.loss_scale_state.scale if fp16 else None

        loss = self._accumulate_grads(micro, scale)
        g = self._grad_flat
        if fp16:
            g.mul_(1.0 / scale)
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
            self.loss_scale_state = update_loss_scale(self.loss_scale_state,
                                                      overflow, self.config.fp16)
        self.global_steps += 1
        self.micro_steps += len(micro)
        self.global_samples += self.train_batch_size()
        self.skipped_steps += int(skipped)
        self._last_metrics = {"loss": loss, "grad_norm": grad_norm, "lr": lr,
                              "overflow": skipped,
                              "loss_scale": self.loss_scale_state.scale}
        if self.global_steps % self.config.steps_per_print == 0:
            log_dist(f"step {self.global_steps}: loss {float(loss):.4f} "
                     f"lr {lr:.3e} grad_norm {float(grad_norm):.4f}", ranks=[0])
        return loss

    @torch.no_grad()
    def eval_batch(self, data_iter=None, batch=None):
        """Mean loss over gas microbatches, no gradients."""
        data = batch if batch is not None else data_iter
        micro = self._stack_microbatches(data)
        return torch.stack([self._loss_fn(self.module, mb).to(torch.float32)
                            for mb in micro]).mean()

    # -- legacy fwd/bwd/step API (reference ``engine.py:1775,1916,2114``)
    def forward(self, *args, **kwargs):
        raise _not_ported("the legacy forward/backward/step API",
                          "Training leftovers")

    backward = step = forward

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
