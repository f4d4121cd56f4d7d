"""Mixed precision: dtype policy + on-device dynamic loss scaling
(counterpart of ``deeperspeed_tpu/runtime/precision.py``).

The scaler state lives on the device as tensors and its update is
``torch.where`` arithmetic, with no host round-trip (the JAX package's
``lax.cond``).  Reference: ``runtime/fp16/loss_scaler.py``
(``DynamicLossScaler``) and the bf16 master-weight scheme
(``runtime/bf16_optimizer.py``).
"""

import dataclasses

import torch


@dataclasses.dataclass
class LossScaleState:
    scale: torch.Tensor           # f32 scalar, current loss scale
    growth_tracker: torch.Tensor  # i32 scalar, good steps since last overflow
    hysteresis: torch.Tensor      # i32 scalar, remaining tolerated overflows
    found_overflow: torch.Tensor  # bool scalar, last step overflowed


def init_loss_scale(fp16_config, device):
    """The initial on-device scaler state from an ``FP16Config``."""
    if fp16_config is not None and fp16_config.enabled:
        scale = (2.0 ** fp16_config.initial_scale_power) if fp16_config.dynamic \
            else fp16_config.loss_scale
    else:
        scale = 1.0
    hysteresis = fp16_config.hysteresis if fp16_config is not None else 2
    return LossScaleState(
        scale=torch.tensor(scale, dtype=torch.float32, device=device),
        growth_tracker=torch.zeros((), dtype=torch.int32, device=device),
        hysteresis=torch.tensor(hysteresis, dtype=torch.int32, device=device),
        found_overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def has_inf_or_nan(tensors):
    """Bool scalar tensor: any non-finite value in ``tensors`` (reference
    ``loss_scaler.py:87``)."""
    bad = None
    for t in tensors:
        b = ~torch.isfinite(t).all()
        bad = b if bad is None else bad | b
    return torch.zeros((), dtype=torch.bool) if bad is None else bad


def update_loss_scale(state, overflow, fp16_config):
    """Dynamic x2 growth / /2 backoff with window and hysteresis (reference
    ``DynamicLossScaler.update_scale``); ``overflow`` is a bool tensor."""
    if fp16_config is None or not fp16_config.enabled or not fp16_config.dynamic:
        return dataclasses.replace(state, found_overflow=overflow)
    hyst0 = torch.full_like(state.hysteresis, fp16_config.hysteresis)

    # overflow branch
    hyst_dec = state.hysteresis - 1
    backoff = hyst_dec <= 0
    o_scale = torch.where(backoff, torch.clamp(state.scale / 2.0,
                                               min=fp16_config.min_loss_scale),
                          state.scale)
    o_hyst = torch.where(backoff, hyst0, hyst_dec)
    # good-step branch
    tracker = state.growth_tracker + 1
    grow = tracker >= fp16_config.loss_scale_window
    g_scale = torch.where(grow, state.scale * 2.0, state.scale)
    g_tracker = torch.where(grow, torch.zeros_like(tracker), tracker)
    g_hyst = hyst0 if fp16_config.consecutive_hysteresis else state.hysteresis

    return LossScaleState(
        scale=torch.where(overflow, o_scale, g_scale),
        growth_tracker=torch.where(overflow, torch.zeros_like(tracker), g_tracker),
        hysteresis=torch.where(overflow, o_hyst, g_hyst),
        found_overflow=overflow.clone(),
    )


ACCUM_DTYPES = {None: torch.float32, "fp32": torch.float32,
                "bf16": torch.bfloat16, "fp16": torch.float16}


class MixedPrecisionPolicy:
    """Dtype roles of the train step: ``param_dtype`` is the compute type of
    the working weights; masters and optimizer state are fp32, and
    ``accum_dtype`` is the type the microbatch gradients are summed in
    (``data_types.grad_accum_dtype``, fp32 by default)."""

    def __init__(self, config):
        self.param_dtype = config.train_dtype
        self.accum_dtype = ACCUM_DTYPES[config.grad_accum_dtype]
        self.is_fp16 = config.fp16.enabled
        self.is_bf16 = config.bf16.enabled
        self.is_mixed = self.is_fp16 or self.is_bf16

    def compute_dtype(self, param, no_cast=False):
        """The type ``param`` takes for compute: every floating weight is
        cast under mixed precision except the ``no_cast`` ones (the
        fork's ``_deepspeed_no_cast``, for embedding tables)."""
        if not self.is_mixed or no_cast or not param.dtype.is_floating_point:
            return param.dtype
        return self.param_dtype
