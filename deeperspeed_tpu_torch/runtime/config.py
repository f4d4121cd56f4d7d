"""JSON config -> typed config (counterpart of ``deeperspeed_tpu/runtime/config.py``).

The subset the single-device training slice reads: the batch triangle
(``train_batch_size`` = micro batch x ``gradient_accumulation_steps`` on
one device), ``optimizer``, ``scheduler``, ``fp16`` / ``bf16``,
``gradient_clipping``, ``seed``, ``steps_per_print``,
``zero_optimization`` with stage 0, ``activation_checkpointing``,
``data_types.grad_accum_dtype``, ``progressive_layer_drop``,
``curriculum_learning`` and ``data_efficiency``.  Any other key raises
``NotImplementedError`` naming the ROADMAP item that ports it: a config
the port would run differently from the JAX package is refused, not
ignored.
"""

import json
from typing import Any, Dict, List, Optional, Union

import torch
from pydantic import Field

from .config_utils import DeeperSpeedConfigModel
from .precision import ACCUM_DTYPES
from .constants import (
    BFLOAT16,
    FP16,
    GRADIENT_ACCUMULATION_STEPS,
    GRADIENT_CLIPPING,
    GRADIENT_CLIPPING_DEFAULT,
    OPTIMIZER,
    SCHEDULER,
    SEED,
    SEED_DEFAULT,
    STEPS_PER_PRINT,
    STEPS_PER_PRINT_DEFAULT,
    TRAIN_BATCH_SIZE,
    TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    ZERO_OPTIMIZATION,
)

SUPPORTED_KEYS = {
    TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    GRADIENT_ACCUMULATION_STEPS, OPTIMIZER, SCHEDULER, FP16, BFLOAT16,
    "bfloat16", GRADIENT_CLIPPING, SEED, STEPS_PER_PRINT, ZERO_OPTIMIZATION,
    "activation_checkpointing", "data_types", "progressive_layer_drop",
    "curriculum_learning", "data_efficiency",
}

# where the keys that the slice refuses will be ported
_ROADMAP = {
    "comm": "Multi-process training",
    "mesh": "Multi-process training",
    "communication_data_type": "Multi-process training",
    "pipeline": "Pipelines",
    "moe": "Llama/Mistral, v1 inference and MoE",
    "checkpoint": "Checkpoints",
    "hybrid_engine": "The rest of the surface",
}


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue A, '{item}')")


class OptimizerParams(DeeperSpeedConfigModel):
    lr: float = 1e-3
    betas: List[float] = [0.9, 0.999]
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.0  # sgd/musgd


class OptimizerConfig(DeeperSpeedConfigModel):
    type: str = "Adam"
    params: OptimizerParams = Field(default_factory=OptimizerParams)


class SchedulerConfig(DeeperSpeedConfigModel):
    type: str = "WarmupLR"
    params: Dict[str, Any] = {}


class FP16Config(DeeperSpeedConfigModel):
    """fp16 with dynamic loss scaling (reference ``runtime/fp16/loss_scaler.py``)."""

    enabled: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0

    @property
    def dynamic(self):
        return self.loss_scale == 0


class BF16Config(DeeperSpeedConfigModel):
    enabled: bool = False


class ActivationCheckpointingConfig(DeeperSpeedConfigModel):
    """Any of ``partition_activations``, ``number_checkpoints`` and
    ``cpu_checkpointing`` turns on block-level recompute (the model's
    ``remat``); on one card there is nothing to partition, and the
    recompute stays on the device."""

    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


class CurriculumParams(DeeperSpeedConfigModel):
    curriculum_type: str = "seqlen"
    min_difficulty: int = 8
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"
    schedule_config: Dict[str, Any] = {}


class CurriculumConfig(DeeperSpeedConfigModel):
    enabled: bool = False
    params: CurriculumParams = Field(default_factory=CurriculumParams)


class ProgressiveLayerDropConfig(DeeperSpeedConfigModel):
    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


class DataEfficiencyConfig(DeeperSpeedConfigModel):
    enabled: bool = False
    seed: int = 1234
    data_sampling: Dict[str, Any] = {}
    data_routing: Dict[str, Any] = {}


class DeeperSpeedConfig:
    """Top-level config from a dict or a path to a JSON file; one device."""

    def __init__(self, config: Union[str, dict]):
        if isinstance(config, str):
            with open(config) as f:
                pd = json.load(f)
        elif isinstance(config, dict):
            pd = dict(config)
        else:
            raise ValueError(f"Expected dict or json path, got {type(config)}")
        for key in pd:
            if key not in SUPPORTED_KEYS:
                raise _not_ported(f"config key {key!r}",
                                  _ROADMAP.get(key, "The rest of the surface"))

        self.train_batch_size = pd.get(TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = pd.get(TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = pd.get(GRADIENT_ACCUMULATION_STEPS)
        self._set_batch_related_parameters()

        self.steps_per_print = pd.get(STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT)
        self.seed = pd.get(SEED, SEED_DEFAULT)
        self.gradient_clipping = pd.get(GRADIENT_CLIPPING, GRADIENT_CLIPPING_DEFAULT)
        self.optimizer = OptimizerConfig(**pd[OPTIMIZER]) if OPTIMIZER in pd else None
        self.scheduler = SchedulerConfig(**pd[SCHEDULER]) if SCHEDULER in pd else None
        self.fp16 = FP16Config(**pd.get(FP16, {}))
        self.bf16 = BF16Config(**pd.get(BFLOAT16, pd.get("bfloat16", {})))
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 are mutually exclusive")

        zero = dict(pd.get(ZERO_OPTIMIZATION, {}))
        stage = zero.pop("stage", 0)
        if stage != 0:
            raise _not_ported(f"zero_optimization.stage {stage}",
                              "Multi-process training")
        if zero:
            raise _not_ported(f"zero_optimization keys {sorted(zero)}",
                              "Offload"
                              if any(k.startswith("offload") for k in zero)
                              else "Multi-process training")
        self.zero_stage = 0
        data_types = dict(pd.get("data_types", {}))
        self.grad_accum_dtype = data_types.pop("grad_accum_dtype", None)
        if data_types:
            raise _not_ported(f"data_types keys {sorted(data_types)}",
                              "The rest of the surface")
        if self.grad_accum_dtype not in ACCUM_DTYPES:
            raise ValueError(f"data_types.grad_accum_dtype {self.grad_accum_dtype!r}: "
                             f"expected fp32, bf16 or fp16")
        self.activation_checkpointing = ActivationCheckpointingConfig(
            **pd.get("activation_checkpointing", {}))
        self.curriculum = CurriculumConfig(**pd.get("curriculum_learning", {}))
        self.progressive_layer_drop = ProgressiveLayerDropConfig(
            **pd.get("progressive_layer_drop", {}))
        self.data_efficiency = DataEfficiencyConfig(**pd.get("data_efficiency", {}))
        self.train_dtype = self._resolve_train_dtype()

    # -- batch triangle (reference ``config.py:914-957`` semantics) on one
    # device: train_batch_size = micro batch x gradient_accumulation_steps
    def _set_batch_related_parameters(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps

        if all(x is not None for x in (train_batch, micro_batch, grad_acc)):
            pass
        elif train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = train_batch // micro_batch
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = train_batch // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train_batch
        elif micro_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_batch_size = micro_batch
        else:
            raise ValueError("Either train_batch_size or "
                             "train_micro_batch_size_per_gpu needs to be provided")
        self._batch_assertion()

    def _batch_assertion(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if not (train_batch > 0 and micro_batch > 0 and grad_acc > 0):
            raise ValueError(f"batch sizes must be positive: train_batch_size "
                             f"{train_batch}, micro batch {micro_batch}, "
                             f"gradient_accumulation_steps {grad_acc}")
        if train_batch != micro_batch * grad_acc:
            raise ValueError(
                f"Check batch related parameters. train_batch_size is not equal "
                f"to micro_batch_per_gpu * gradient_acc_step on one device: "
                f"{train_batch} != {micro_batch} * {grad_acc}")

    def _resolve_train_dtype(self):
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32
