"""``initialize()`` -- the training entry point (counterpart of
``deeperspeed_tpu/runtime/initialize.py``).

Returns the reference's 4-tuple ``(engine, optimizer, dataloader,
lr_scheduler)``.  Over several processes it joins the process group first
(``comm.init_distributed``, from the ``RANK``/``WORLD_SIZE`` environment)
unless the caller already has.  ``mesh=`` is a ``parallel.MeshTopology``
over the processes; without it the mesh is built from the config as the
JAX engine builds it (``engine.py:100-125``): ``tp`` from
``mesh.model_parallel_size``, ``ep`` from ``mesh.expert_parallel_size``,
``zshard`` from ``mics_shard_size`` / ``zero_hpz_partition_size``, ``sp``
from ``mesh.sequence_parallel_size``, ``dp``
what the world leaves, ``pp`` from ``mesh.pipe_parallel_size`` (outermost).
``comm.quantized.moe_alltoall`` sets the MoE transport of the model's
config.  An ``mpu`` is accepted and superseded by the mesh, as in the JAX
engine (the hybrid engine's config block is refused by the config).

A pipeline model -- a stage model (``GPTNeoXPipe``, ``LlamaPipe``) or a
``PipelineModule`` -- goes to a pipeline engine by ``pipeline.executor``
(the JAX package's ``_build_pipeline_engine``): ``compiled`` to
``PipelineEngine``, ``interpreted`` to ``InterpretedPipelineEngine``,
``auto`` to the first where the model converts (a ``PipelineModule`` of
GPT-NeoX / Llama blocks), else the second.  The port has no compiled
program: both engines run instruction streams on per-stage processes.
"""

import os

from .. import comm
from ..parallel import MeshTopology, set_mesh
from .config import DeeperSpeedConfig
from .engine import DeeperSpeedEngine
from ..utils.logging import log_dist


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None, mesh=None,
               loss_fn=None, config_params=None, device=None):
    """``device`` is CUDA unless the caller passes ``device="cpu"``.  When
    this call joins the process group, it does so over ``nccl`` on CUDA and
    ``gloo`` on the CPU; processes that share a GPU call
    ``init_distributed("gloo", ...)`` first."""
    if model is None:
        raise ValueError("deeperspeed_tpu_torch.initialize requires a model")
    if config is None:
        config = config_params
    if config is None and args is not None and hasattr(args, "deepspeed_config"):
        config = args.deepspeed_config
    if config is None:
        raise ValueError("no config: pass config= or args.deepspeed_config")
    if int(os.environ.get("WORLD_SIZE", 1)) > 1 and dist_init_required is not False:
        comm.init_distributed(
            dist_backend="gloo" if str(device).startswith("cpu") else "nccl")
    from .pipe.module import PipelineModule

    pipeline = isinstance(model, PipelineModule) or hasattr(model, "build_stage")
    if mesh is not None:
        mesh = set_mesh(MeshTopology(**mesh.sizes))
        if not isinstance(config, DeeperSpeedConfig):
            config = DeeperSpeedConfig(config, world_size=mesh.data_parallel_size)
    else:
        if not isinstance(config, DeeperSpeedConfig):
            if (isinstance(config, dict) and isinstance(model, PipelineModule)
                    and "pipe_parallel_size" not in config.get("mesh", {})):
                # the JAX interpreted engine's mesh: pp from the module
                config = {**config, "mesh": {**config.get("mesh", {}),
                                             "pipe_parallel_size": model.num_stages}}
            config = DeeperSpeedConfig(config)
        mc = config.mesh_config
        set_mesh(MeshTopology(pp=mc.pipe_parallel_size, tp=mc.model_parallel_size,
                              dp=mc.data_parallel_size, zshard=config.zshard_size,
                              ep=mc.expert_parallel_size, sp=mc.sequence_parallel_size))
    kwargs = dict(optimizer=optimizer, model_parameters=model_parameters,
                  training_data=training_data, lr_scheduler=lr_scheduler, loss_fn=loss_fn,
                  collate_fn=collate_fn, device=device)
    if pipeline:
        engine = _build_pipeline_engine(model, config, **kwargs)
    else:
        _apply_moe_quantized_alltoall(model, config)
        engine = DeeperSpeedEngine(model=model, config=config, **kwargs)
    log_dist("initialize() complete", ranks=[0])
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


def _apply_moe_quantized_alltoall(model, config):
    """``comm.quantized.moe_alltoall`` turns the MoE dispatch of a model
    with experts onto the block-scaled wire (the JAX package's
    ``_apply_moe_quantized_alltoall``): its config's
    ``moe_quantized_alltoall``, ``moe_quantized_group_size`` (the block's
    ``group_size``) and ``moe_quantized_alltoall_dtype``.  Other models
    pass untouched."""
    cq = config.comm_quantized
    mcfg = getattr(model, "config", None)
    if not (cq.moe_alltoall and hasattr(mcfg, "moe_quantized_alltoall")
            and getattr(mcfg, "has_moe", False)):
        return
    model.replace_config(moe_quantized_alltoall=True, moe_quantized_group_size=cq.group_size,
                         moe_quantized_alltoall_dtype=cq.moe_alltoall_dtype)


def _build_pipeline_engine(model, config, **kwargs):
    """Route a pipeline model by ``pipeline.executor`` (the JAX package's
    ``_build_pipeline_engine``, its checks and messages):

    * ``compiled`` -- ``PipelineEngine``: a stage model, or a
      ``PipelineModule`` of GPT-NeoX / Llama blocks;
    * ``interpreted`` -- ``InterpretedPipelineEngine``: any
      ``PipelineModule`` (``TiedLayerSpec`` ties), its loss the module's;
    * ``auto`` -- ``PipelineEngine`` where the model converts, else the
      interpreted engine."""
    from .pipe.engine import PipelineEngine, PipelineError, _pipe_module_to_stage_model
    from .pipe.interpreted import InterpretedPipelineEngine
    from .pipe.module import PipelineModule

    executor = config.pipeline.executor
    if executor not in ("auto", "compiled", "interpreted"):
        raise ValueError(
            f"pipeline.executor={executor!r}: expected "
            "'auto', 'compiled' or 'interpreted'")

    def interpreted():
        # the loss comes from PipelineModule(..., loss_fn=...); an explicit
        # loss_fn would be ignored, so the ambiguity is refused
        if kwargs.get("loss_fn") is not None:
            raise ValueError(
                "the interpreted pipeline takes its loss from "
                "PipelineModule(..., loss_fn=...); remove the loss_fn= "
                "argument to initialize()")
        if kwargs.get("model_parameters") is not None:
            raise ValueError(
                "model_parameters= is not supported on the interpreted "
                "pipeline path (params build per stage from the LayerSpecs)")
        kw = {k: v for k, v in kwargs.items() if k not in ("loss_fn", "model_parameters")}
        return InterpretedPipelineEngine(model, config, **kw)

    if executor == "interpreted":
        if not isinstance(model, PipelineModule):
            raise ValueError(
                "pipeline.executor='interpreted' needs a PipelineModule; "
                f"got a stage model ({type(model).__name__})")
        return interpreted()
    if not isinstance(model, PipelineModule) or executor == "compiled":
        return PipelineEngine(model=model, config=config, **kwargs)
    try:
        _pipe_module_to_stage_model(model)
    except PipelineError:
        return interpreted()
    return PipelineEngine(model=model, config=config, **kwargs)
