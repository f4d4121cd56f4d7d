"""JSON config -> typed config (counterpart of ``deeperspeed_tpu/runtime/config.py``).

The subset the training slices read: the batch triangle
(``train_batch_size`` = micro batch x ``gradient_accumulation_steps`` x
the data-parallel world), ``optimizer``, ``scheduler``, ``fp16`` /
``bf16``, ``gradient_clipping``, ``seed``, ``steps_per_print``,
``zero_optimization`` (stages 0-3, ``param_persistence_threshold``,
``zero_quantized_gradients``, and the bucket, overlap and checkpoint knobs
the JAX package accepts and ignores), ``communication_data_type``,
``comm.quantized`` (qgZ), ``mesh.data_parallel_size``,
``activation_checkpointing``, ``data_types.grad_accum_dtype``,
``progressive_layer_drop``, ``curriculum_learning``, ``data_efficiency``
and ``checkpoint``.  Any other key raises ``NotImplementedError`` naming
the ROADMAP item that ports it: a config the port would run differently
from the JAX package is refused, not ignored.
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
    "curriculum_learning", "data_efficiency", "comm", "mesh",
    "communication_data_type", "checkpoint",
}

# where the keys that the slice refuses will be ported
_ROADMAP = {
    "pipeline": "Pipelines",
    "moe": "Llama/Mistral, v1 inference and MoE",
    "hybrid_engine": "The rest of the surface",
}


PART2 = "Multi-process training, part 2"

# zero_optimization knobs that tune eager bucketing and overlap; the JAX
# package accepts and ignores them (XLA schedules its collectives), and so
# does the port (each reduction is one collective over a flat buffer)
IGNORED_ZERO_KEYS = {
    "contiguous_gradients", "reduce_scatter", "reduce_bucket_size",
    "allgather_partitions", "allgather_bucket_size", "overlap_comm",
    "sub_group_size", "prefetch_bucket_size", "max_live_parameters",
    "max_reuse_distance", "round_robin_gradients", "ignore_unused_parameters",
}
# knobs whose default turns the feature off, accepted at that value
_NO_OP_ZERO_KEYS = {"zero_hpz_partition_size": (1, -1, 0), "mics_shard_size": (1, -1, 0),
                    "zero_quantized_weights": (False,)}
# checkpoint knobs the JAX package accepts as fields and does not act on:
# its checkpoints always hold whole fp32 masters
_CHECKPOINT_ZERO_KEYS = {"load_from_fp32_weights": True, "elastic_checkpoint": False,
                         "gather_16bit_weights_on_model_save": False}
COMM_DTYPES = {None: None, "fp32": torch.float32, "bf16": torch.bfloat16,
               "fp16": torch.float16}


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


class CheckpointConfig(DeeperSpeedConfigModel):
    """``checkpoint``: the JAX package's fields (its ``CheckpointConfig``)."""

    tag_validation: str = "Warn"  # Ignore | Warn | Fail
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = {}
    # storage engine: "native" (sync) | "async" (background writer);
    # async_save=True is a shorthand for "async"
    writer: Optional[str] = None
    async_save: bool = False
    # the load path verifies each file's sha256 against the tag's manifest
    # and walks back to the newest valid tag unless strict_load; transient
    # IO errors retry with capped exponential backoff
    # (io_retry_base_s * 2^attempt, at most io_retry_cap_s)
    verify_on_load: bool = True
    strict_load: bool = False
    io_retries: int = 3
    io_retry_base_s: float = 0.05
    io_retry_cap_s: float = 2.0


class CommQuantizedConfig(DeeperSpeedConfigModel):
    """``comm.quantized``: the qgZ gradient reduction (flat schedule).
    ``wire_dtype`` is ``int8`` or ``fp8`` (e5m2 on the gradient wire);
    ``impl`` names the JAX package's B5 backend (``auto`` / ``pallas`` /
    ``xla``, bit-equal there): the port takes B5 on the card and its plain
    version on the CPU whatever it says."""

    enabled: bool = False
    group_size: int = 128
    impl: str = "auto"
    wire_dtype: str = "int8"


class MeshConfig(DeeperSpeedConfigModel):
    """``mesh``: the data-parallel degree is the process count; every other
    axis is 1 until its ROADMAP item lands."""

    pipe_parallel_size: int = 1
    model_parallel_size: int = 1
    sequence_parallel_size: int = 1
    expert_parallel_size: int = 1
    data_parallel_size: Optional[int] = None


_MESH_ITEMS = {"pipe_parallel_size": "Pipelines",
               "model_parallel_size": PART2,
               "sequence_parallel_size": "Sequence parallelism",
               "expert_parallel_size": "Llama/Mistral, v1 inference and MoE"}


def _known(block, model, where):
    """Refuse keys of ``block`` that ``model`` does not declare."""
    unknown = sorted(set(block) - set(model.model_fields))
    if unknown:
        raise _not_ported(f"{where} keys {unknown}", PART2)


def _world_size():
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class DeeperSpeedConfig:
    """Top-level config from a dict or a path to a JSON file.  ``world_size``
    (the data-parallel process count) defaults to the ``torch.distributed``
    world, 1 without one."""

    def __init__(self, config: Union[str, dict], world_size=None):
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

        self.mesh_config = self._mesh(pd.get("mesh", {}))
        if world_size is None:
            world_size = _world_size()
        dp = self.mesh_config.data_parallel_size
        if dp is not None and dp != world_size:
            raise ValueError(f"mesh.data_parallel_size {dp} must equal the process "
                             f"count {world_size}: one process drives one device")
        self.world_size = world_size
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

        self._zero(dict(pd.get(ZERO_OPTIMIZATION, {})))
        self._comm(dict(pd.get("comm", {})))
        self.communication_data_type = pd.get("communication_data_type")
        if self.communication_data_type not in COMM_DTYPES:
            raise ValueError(f"communication_data_type {self.communication_data_type!r}: "
                             f"expected fp32, bf16 or fp16")
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
        checkpoint = dict(pd.get("checkpoint", {}))
        _known(checkpoint, CheckpointConfig, "checkpoint")
        self.checkpoint_config = CheckpointConfig(**checkpoint)
        if self.checkpoint_config.tag_validation.lower() not in ("ignore", "warn", "fail"):
            raise ValueError(f"checkpoint.tag_validation "
                             f"{self.checkpoint_config.tag_validation!r}: expected "
                             f"Ignore, Warn or Fail")
        self.train_dtype = self._resolve_train_dtype()

    @staticmethod
    def _mesh(block):
        _known(block, MeshConfig, "mesh")
        mesh = MeshConfig(**block)
        for key, item in _MESH_ITEMS.items():
            if getattr(mesh, key) != 1:
                raise _not_ported(f"mesh.{key} {getattr(mesh, key)}", item)
        return mesh

    def _zero(self, zero):
        """``zero_optimization``: the stage and what it reads."""
        self.zero_stage = zero.pop("stage", 0)
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage {self.zero_stage}: expected 0-3")
        self.param_persistence_threshold = zero.pop("param_persistence_threshold",
                                                    100_000)
        self.zero_quantized_gradients = bool(zero.pop("zero_quantized_gradients", False))
        for key, default in _CHECKPOINT_ZERO_KEYS.items():
            setattr(self, key, bool(zero.pop(key, default)))
        for key in IGNORED_ZERO_KEYS:
            zero.pop(key, None)
        for key, no_op in _NO_OP_ZERO_KEYS.items():
            if key in zero and zero[key] in no_op:
                zero.pop(key)
        if zero:
            keys = sorted(zero)
            item = ("Offload" if any(k.startswith(("offload", "cpu_offload")) for k in keys)
                    else PART2)
            raise _not_ported(f"zero_optimization keys {keys}", item)

    def _comm(self, comm):
        """``comm``: the flat qgZ block; overlap and scheduling are part 2."""
        quantized = dict(comm.pop("quantized", {}))
        if quantized.pop("intra_axis", None) is not None:
            raise _not_ported("comm.quantized.intra_axis (the two-level qgZ schedule)",
                              PART2)
        if quantized.pop("moe_alltoall", False):
            raise _not_ported("comm.quantized.moe_alltoall",
                              "Llama/Mistral, v1 inference and MoE")
        quantized.pop("moe_alltoall_dtype", None)
        if comm:
            raise _not_ported(f"comm keys {sorted(comm)}", PART2)
        _known(quantized, CommQuantizedConfig, "comm.quantized")
        self.comm_quantized = CommQuantizedConfig(**quantized)
        cq = self.comm_quantized
        if cq.impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"comm.quantized.impl {cq.impl!r}: expected auto, pallas or xla")
        if cq.wire_dtype not in ("int8", "fp8", "fp8_e5m2"):
            raise ValueError(f"comm.quantized.wire_dtype {cq.wire_dtype!r}: expected "
                             f"int8 or fp8")

    # -- batch triangle (reference ``config.py:914-957`` semantics):
    # train_batch_size = micro batch x gradient_accumulation_steps x world
    def _set_batch_related_parameters(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        ws = self.world_size

        if all(x is not None for x in (train_batch, micro_batch, grad_acc)):
            pass
        elif train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = train_batch // (micro_batch * ws)
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = train_batch // ws // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * ws
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train_batch // ws
        elif micro_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_batch_size = micro_batch * ws
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
        if train_batch != micro_batch * grad_acc * self.world_size:
            raise ValueError(
                f"Check batch related parameters. train_batch_size is not equal "
                f"to micro_batch_per_gpu * gradient_acc_step * world_size: "
                f"{train_batch} != {micro_batch} * {grad_acc} * {self.world_size}")

    def _resolve_train_dtype(self):
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32
