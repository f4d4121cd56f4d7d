"""JSON config -> typed config (counterpart of ``deeperspeed_tpu/runtime/config.py``).

The subset the training slices read: the batch triangle
(``train_batch_size`` = micro batch x ``gradient_accumulation_steps`` x
the data-parallel world), ``optimizer``, ``scheduler``, ``fp16`` /
``bf16``, ``gradient_clipping``, ``seed``, ``steps_per_print``,
``zero_optimization`` (stages 0-3, ``param_persistence_threshold``,
``zero_quantized_gradients``, ``zero_quantized_weights`` (qwZ, stage 3),
``offload_optimizer`` (the pinned-host and NVMe tiers and the host update),
``offload_param`` and ``cpu_offload``, and the bucket, overlap and
checkpoint knobs the JAX package accepts and ignores),
``communication_data_type``, ``comm.quantized`` (qgZ),
``comm.overlap`` (the deferred and bucketed gradient reduction),
``comms_logger``, ``mesh.data_parallel_size``, ``model_parallel_size`` and
``pipe_parallel_size`` (the ``pp`` axis), ``pipeline`` (the pipeline
engines' executor and schedule),
MiCS and hpZ (``mics_shard_size``, ``zero_hpz_partition_size``: the
mesh's ``zshard`` axis),
``activation_checkpointing``, ``data_types.grad_accum_dtype``,
``progressive_layer_drop``, ``curriculum_learning``, ``data_efficiency``
and ``checkpoint``.  Any other key raises ``NotImplementedError`` naming
the ROADMAP item that ports it: a config the port would run differently
from the JAX package is refused, not ignored.
"""

import json
from typing import Any, Dict, List, Literal, Optional, Union

import torch
from pydantic import Field

from ..parallel import topology as topo
from ..utils.logging import logger
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
    "communication_data_type", "checkpoint", "comms_logger", "pipeline",
    # accepted as the JAX config accepts it; nothing there reads it (the
    # sequence-parallel exchanges run in the activations' type)
    "seq_parallel_communication_data_type",
    # MoE is configured on the model in both packages: the JAX config takes
    # a top-level ``moe`` block under its extra="allow" policy and acts on
    # nothing in it, and so does the port
    "moe",
}

# where the keys that the slice refuses will be ported
_ROADMAP = {
    "hybrid_engine": "The rest of the surface",
}


REST = "The rest of the surface"

# upstream's zero_optimization knobs for its eager bucketing and overlap;
# the JAX package accepts and ignores them (XLA schedules its collectives),
# and so does the port, whose gradient reduction is bucketed and deferred by
# comm.overlap (bucket_mb, deferred_reduction) instead
IGNORED_ZERO_KEYS = {
    "contiguous_gradients", "reduce_scatter", "reduce_bucket_size",
    "allgather_partitions", "allgather_bucket_size", "overlap_comm",
    "sub_group_size", "prefetch_bucket_size", "max_live_parameters",
    "max_reuse_distance", "round_robin_gradients", "ignore_unused_parameters",
    # the JAX package's field, read by nothing there either: MiCS's gathers
    # already stay within the zshard group
    "mics_hierarchical_params_gather",
}
# the MiCS / hpZ subgroup sizes: at or below 1 the feature is off
_ZSHARD_KEYS = ("mics_shard_size", "zero_hpz_partition_size")
# checkpoint knobs the JAX package accepts as fields and does not act on:
# its checkpoints always hold whole fp32 masters
_CHECKPOINT_ZERO_KEYS = {"load_from_fp32_weights": True, "elastic_checkpoint": False,
                         "gather_16bit_weights_on_model_save": False}
COMM_DTYPES = {None: None, "fp32": torch.float32, "bf16": torch.bfloat16,
               "fp16": torch.float16}


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue A, '{item}')")


def pipe_auto_refusal():
    """``comm.overlap.schedule.mode: auto`` over a pipeline: the cost-model
    schedule of a pipeline waits for a reference whose own ``auto`` path
    runs (the JAX engines' ``auto`` fails on the jax it is held against)."""
    return NotImplementedError(
        "comm.overlap.schedule.mode 'auto' over a pipeline is not ported yet "
        "(ROADMAP Queue A, 'Pipelines'): it waits for a reference whose own 'auto' "
        "path runs")


def pipe_compressed_refusal():
    """qgZ and 1-bit Adam over a pipeline: the reference does not run them."""
    return NotImplementedError(
        "the compressed gradient reductions (qgZ, 1-bit Adam) over a pipeline are not "
        "supported: the reference does not run them (the JAX PipelineEngine fails on "
        "both with a TypeError)")


def sp_qgz_refusal(what, error):
    """qgZ on the sequence-parallel axis (its first hop on ``sp``, or over
    ring attention): the reference fails on both, with ``error``."""
    return NotImplementedError(
        f"{what} under qgZ is not supported: the reference does not run it (the JAX "
        f"engine fails with {error!r})")


class OptimizerParams(DeeperSpeedConfigModel):
    lr: float = 1e-3
    betas: List[float] = [0.9, 0.999]
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.0  # sgd/musgd
    # 1-bit Adam: exact-Adam warm-up steps before the compressed reduction
    freeze_step: int = 100


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


class OffloadOptimizerConfig(DeeperSpeedConfigModel):
    """``zero_optimization.offload_optimizer`` (the JAX package's fields and
    defaults).  ``device``: ``none``, ``cpu`` (each rank's fp32 masters and
    optimizer state live in pinned host memory between steps; the update
    runs on the card) or ``nvme`` (the optimizer state also goes to
    ``nvme_path`` between steps through the aio pool of ``buffer_count``
    threads; ``pipeline_write`` leaves the flush in flight until the next
    step's swap-in).  ``host_update`` (with ``cpu``): the update runs on the
    host cores (``ops/adam/cpu_adam.py``) over host fp32 masters and moments
    and the card holds only the compute parameters; ``wire_dtype`` ``bf16``
    halves the gradients' bytes to the host.  ``pin_memory``,
    ``pipeline_read``, ``fast_init`` and ``ratio`` are accepted and not
    acted on, as in the JAX package."""

    device: Literal["none", "cpu", "nvme"] = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = True
    fast_init: bool = False
    ratio: float = 1.0
    host_update: bool = False
    wire_dtype: Optional[Literal["fp32", "bf16"]] = None


class OffloadParamConfig(DeeperSpeedConfigModel):
    """``zero_optimization.offload_param``: accepted and not acted on, as in
    the JAX package, whose parameter tier is ``ZeroInfinityEngine``
    (``runtime/zero/infinity.py``), built directly."""

    device: Literal["none", "cpu", "nvme"] = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False


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
    """``comm.quantized``: the qgZ gradient reduction over the ZeRO group.
    ``intra_axis`` (``dp`` or ``zshard``) names the first hop of the
    two-hop schedule, the rest of the group the second (the JAX engine's
    rule: ``dp`` alone with ``zshard`` 1 is the flat schedule; an axis of
    one process is a trivial hop); unset, the schedule is two-hop over
    ``zshard`` then ``dp`` where both span more than one process.
    ``wire_dtype`` is ``int8`` or ``fp8`` (e5m2 on the gradient wire);
    ``impl`` names the JAX package's B5 backend (``auto`` / ``pallas`` /
    ``xla``, bit-equal there): the port takes B5 on the card and its plain
    version on the CPU whatever it says.  ``moe_alltoall`` (with
    ``moe_alltoall_dtype``, ``int8`` or ``fp8`` for e4m3) sends the MoE
    dispatch through the block-scaled round trip in groups of
    ``group_size`` (``initialize`` sets it on the model, as the JAX
    package's ``_apply_moe_quantized_alltoall`` does)."""

    enabled: bool = False
    group_size: int = 128
    impl: str = "auto"
    wire_dtype: str = "int8"
    intra_axis: Optional[str] = None
    moe_alltoall: bool = False
    moe_alltoall_dtype: str = "int8"


class CommScheduleConfig(DeeperSpeedConfigModel):
    """``comm.overlap.schedule`` (the JAX package's fields and defaults),
    read only under ``comm.overlap.enabled``, as in the JAX engine.
    ``mode``: ``manual`` places the deferred reduction where it is
    eligible, ``off`` reduces every microbatch at every stage, ``auto``
    plans the schedule and bucket size with the cost model of
    ``comm/schedule.py`` and issues each reduction from gradient hooks.
    ``memory``: ``auto`` plans the stage-3 gather/release movement
    (analysis) and checks only the largest parameter against
    ``hbm_budget_bytes``; ``static`` with a budget raises
    ``HBMBudgetError`` at construction where stage 3's full residency does
    not fit (``comm/memplan.py``)."""

    mode: Literal["auto", "manual", "off"] = "manual"
    memory: Literal["auto", "static", "off"] = "static"
    hbm_budget_bytes: Optional[int] = Field(None, ge=0)


class CommOverlapConfig(DeeperSpeedConfigModel):
    """``comm.overlap`` (the JAX package's fields and defaults):

    * ``deferred_reduction``: stages 2-3 (and 0-1, which already reduce
      once a batch) accumulate local gradients across the microbatches and
      reduce once a batch; ``bucket_mb`` splits that reduction into
      collectives of at most that many MiB, issued in order (0: one);
    * ``xla_latency_hiding``: TPU compiler flags; one warning on the card;
    * ``prefetch_depth``: the engine's loader runs that many steps' batches
      ahead, copied to the card on a side stream
      (``dataloader.DevicePrefetchingLoader``);
    * ``eager_async``: ``async_op=True`` on the facade's collectives
      returns a handle."""

    enabled: bool = False
    deferred_reduction: bool = True
    bucket_mb: float = 0.0
    xla_latency_hiding: bool = False
    prefetch_depth: int = 1
    eager_async: bool = False
    schedule: CommScheduleConfig = Field(default_factory=CommScheduleConfig)


class CommsConfig(DeeperSpeedConfigModel):
    """``comms_logger``: time and log every eager collective
    (``comm.log_summary`` prints the table)."""

    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = []


class PipelineRuntimeConfig(DeeperSpeedConfigModel):
    """``pipeline`` (the JAX package's ``PipelineRuntimeConfig``):
    ``executor`` routes a pipeline model (``auto``: a stage model, or a
    ``PipelineModule`` of GPT-NeoX / Llama blocks, to ``PipelineEngine``,
    any other ``PipelineModule`` to ``InterpretedPipelineEngine``;
    ``compiled`` / ``interpreted`` force one), ``schedule`` is ``1f1b`` or
    ``gpipe``.  The JAX package's other fields are accepted and not acted
    on, as there."""

    stages: Union[int, str] = "auto"
    partition: str = "best"
    seed_layers: bool = False
    activation_checkpoint_interval: int = 0
    pipe_partitioned: bool = True
    grad_partitioned: bool = True
    use_reentrant: bool = False
    micro_batches_per_step: Optional[int] = None
    executor: str = "auto"
    schedule: str = "1f1b"


class MeshConfig(DeeperSpeedConfigModel):
    """``mesh``: ``pipe_parallel_size`` is the ``pp`` axis,
    ``model_parallel_size`` the ``tp`` axis and ``data_parallel_size`` the
    ``dp`` axis (by default what the world leaves), ``expert_parallel_size``
    the ``ep`` axis (MoE) and ``sequence_parallel_size`` the ``sp`` axis
    (sequence parallelism)."""

    pipe_parallel_size: int = 1
    model_parallel_size: int = 1
    sequence_parallel_size: int = 1
    expert_parallel_size: int = 1
    data_parallel_size: Optional[int] = None


def _known(block, model, where):
    """Refuse keys of ``block`` that ``model`` does not declare."""
    unknown = sorted(set(block) - set(model.model_fields))
    if unknown:
        raise _not_ported(f"{where} keys {unknown}", REST)


def _world_size():
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class DeeperSpeedConfig:
    """Top-level config from a dict or a path to a JSON file.  ``world_size``
    (the data-parallel degree, ``dp x zshard``) defaults to the
    ``torch.distributed`` world (1 without one) over
    ``mesh.model_parallel_size`` times ``mesh.pipe_parallel_size``."""

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
        self._pipe_auto(self.mesh_config, pd.get("comm", {}))
        self._zero(dict(pd.get(ZERO_OPTIMIZATION, {})))
        if world_size is None:
            world, tp = _world_size(), self.mesh_config.model_parallel_size
            pp = self.mesh_config.pipe_parallel_size
            if world % (tp * pp):
                raise ValueError(f"mesh.model_parallel_size {tp} x pipe_parallel_size {pp} "
                                 f"does not divide the process count {world}")
            world_size = world // (tp * pp)
        ep, sp = self.mesh_config.expert_parallel_size, self.mesh_config.sequence_parallel_size
        if world_size % ep:
            raise ValueError(f"mesh.expert_parallel_size {ep} does not divide the "
                             f"data-parallel process count {world_size}")
        if world_size % (ep * sp):
            raise ValueError(f"mesh.sequence_parallel_size {sp} does not divide the "
                             f"data-parallel process count {world_size} over "
                             f"expert_parallel_size {ep}")
        dp = self.mesh_config.data_parallel_size
        if dp is not None and dp * self.zshard_size * ep * sp != world_size:
            raise ValueError(f"mesh.data_parallel_size {dp} x zshard {self.zshard_size} "
                             f"x ep {ep} x sp {sp} "
                             f"must equal the data-parallel process count {world_size}: "
                             f"one process drives one device")
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

        self._comm(dict(pd.get("comm", {})))
        comms = dict(pd.get("comms_logger", {}))
        _known(comms, CommsConfig, "comms_logger")
        self.comms_config = CommsConfig(**comms)
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
        pipeline = dict(pd.get("pipeline", {}))
        _known(pipeline, PipelineRuntimeConfig, "pipeline")
        self.pipeline = PipelineRuntimeConfig(**pipeline)
        self.train_dtype = self._resolve_train_dtype()

    @staticmethod
    def _mesh(block):
        _known(block, MeshConfig, "mesh")
        return MeshConfig(**block)

    @staticmethod
    def _pipe_auto(mesh, comm):
        """Refuse the cost-model schedule over a pipeline before the layout
        is resolved (:func:`pipe_auto_refusal`)."""
        overlap = dict(comm.get("overlap", {}))
        mode = dict(overlap.get("schedule", {})).get("mode", "manual")
        if mesh.pipe_parallel_size > 1 and overlap.get("enabled") and mode == "auto":
            raise pipe_auto_refusal()

    def _zero(self, zero):
        """``zero_optimization``: the stage and what it reads."""
        self.zero_stage = zero.pop("stage", 0)
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage {self.zero_stage}: expected 0-3")
        self.param_persistence_threshold = zero.pop("param_persistence_threshold",
                                                    100_000)
        self.zero_quantized_gradients = bool(zero.pop("zero_quantized_gradients", False))
        self.zero_quantized_weights = bool(zero.pop("zero_quantized_weights", False))
        if self.zero_quantized_weights and self.zero_stage < 3:
            # the JAX engine quantizes only stage 3's gathers
            logger.warning("zero_quantized_weights: qwZ quantizes stage 3's parameter "
                           "gathers; stage %d gathers none, ignoring", self.zero_stage)
            self.zero_quantized_weights = False
        for key, default in _CHECKPOINT_ZERO_KEYS.items():
            setattr(self, key, bool(zero.pop(key, default)))
        for key in IGNORED_ZERO_KEYS:
            zero.pop(key, None)
        self._offload(zero)
        # MiCS and hpZ: both become the mesh's zshard axis, so conflicting
        # sizes are refused (the JAX engine's ``engine.py:100-116``); hpZ
        # below stage 3 partitions as stage 1-2 do (no compute shards)
        for key in _ZSHARD_KEYS:
            setattr(self, key, max(1, int(zero.pop(key, 1))))
        mics, hpz = self.mics_shard_size, self.zero_hpz_partition_size
        if mics > 1 and hpz > 1 and mics != hpz:
            raise ValueError(
                f"mics_shard_size={mics} conflicts with zero_hpz_partition_size={hpz}: "
                f"both map to the zshard mesh axis and must agree")
        self.zshard_size = max(mics, hpz)
        if zero:
            raise _not_ported(f"zero_optimization keys {sorted(zero)}", REST)

    def _offload(self, zero):
        """``offload_optimizer``, ``offload_param`` and the legacy
        ``cpu_offload`` flag (the JAX config's ``offload_optimizer: {device:
        cpu}``)."""
        if zero.pop("cpu_offload", None) and "offload_optimizer" not in zero:
            logger.warning("zero_optimization.cpu_offload is deprecated, use offload_optimizer")
            zero["offload_optimizer"] = {"device": "cpu"}
        blocks = {}
        for key, model in (("offload_optimizer", OffloadOptimizerConfig),
                           ("offload_param", OffloadParamConfig)):
            block = zero.pop(key, None)
            if block is not None:
                _known(dict(block), model, f"zero_optimization.{key}")
                blocks[key] = model(**block)
        self.offload_optimizer = blocks.get("offload_optimizer")
        self.offload_param = blocks.get("offload_param")
        off = self.offload_optimizer
        if off is not None and off.host_update and off.device != "cpu":
            raise ValueError(f"offload_optimizer.host_update requires device 'cpu' (got "
                             f"{off.device!r}); the NVMe tier keeps the device-side update")
        if off is not None and off.device == "nvme" and not off.nvme_path:
            raise ValueError("offload_optimizer.device='nvme' requires nvme_path")

    @property
    def offload_optimizer_device(self):
        return self.offload_optimizer.device if self.offload_optimizer else "none"

    def _comm(self, comm):
        """``comm``: ``quantized`` (qgZ) and ``overlap`` (with its
        ``schedule``).  Refused: an
        ``intra_axis`` on ``sp``, which the reference fails on, ``tp``, whose
        ranks hold different slices of the parameters, ``pp``, whose ranks
        hold different parameters, and ``ep`` (qgZ needs ``ep`` 1, as in the
        JAX engine)."""
        quantized = dict(comm.pop("quantized", {}))
        overlap = dict(comm.pop("overlap", {}))
        intra = quantized.get("intra_axis")
        if intra is not None and intra not in topo.ALL_AXES:
            raise ValueError(f"comm.quantized.intra_axis {intra!r}: expected one of "
                             f"{list(topo.ALL_AXES)}")
        if intra == topo.SP_AXIS:
            raise sp_qgz_refusal("comm.quantized.intra_axis 'sp'",
                                 "AssertionError: dim 0 (1) not divisible by 2")
        if intra in (topo.TP_AXIS, topo.EP_AXIS, topo.PP_AXIS):
            raise ValueError(f"comm.quantized.intra_axis {intra!r}: the qgZ hops run over "
                             f"the data-parallel axes dp and zshard")
        if comm:
            raise _not_ported(f"comm keys {sorted(comm)}", REST)
        _known(quantized, CommQuantizedConfig, "comm.quantized")
        self.comm_quantized = CommQuantizedConfig(**quantized)
        cq = self.comm_quantized
        if cq.impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"comm.quantized.impl {cq.impl!r}: expected auto, pallas or xla")
        if cq.wire_dtype not in ("int8", "fp8", "fp8_e5m2"):
            raise ValueError(f"comm.quantized.wire_dtype {cq.wire_dtype!r}: expected "
                             f"int8 or fp8")
        _known(overlap, CommOverlapConfig, "comm.overlap")
        _known(dict(overlap.get("schedule", {})), CommScheduleConfig,
               "comm.overlap.schedule")
        self.comm_overlap = ov = CommOverlapConfig(**overlap)
        if ov.bucket_mb < 0:
            raise ValueError(f"comm.overlap.bucket_mb {ov.bucket_mb}: expected >= 0")

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
