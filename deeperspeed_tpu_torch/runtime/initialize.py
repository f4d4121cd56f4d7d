"""``initialize()`` -- the training entry point (counterpart of
``deeperspeed_tpu/runtime/initialize.py``).

Returns the reference's 4-tuple ``(engine, optimizer, dataloader,
lr_scheduler)``.  Over several processes it joins the process group first
(``comm.init_distributed``, from the ``RANK``/``WORLD_SIZE`` environment)
unless the caller already has.  ``mesh=`` is a ``parallel.MeshTopology``
over the processes; without it the mesh is built from the config as the
JAX engine builds it (``engine.py:100-125``): ``tp`` from
``mesh.model_parallel_size``, ``ep`` from ``mesh.expert_parallel_size``,
``zshard`` from ``mics_shard_size`` / ``zero_hpz_partition_size``, ``dp``
what the world leaves.  ``comm.quantized.moe_alltoall`` sets the MoE
transport of the model's config.  An ``mpu`` is
accepted and superseded by the mesh, as in the JAX engine, unless it asks
for pipeline stages; a pipeline model raises ``NotImplementedError`` (the
hybrid engine's config block is refused by the config).
"""

import os

from .. import comm
from ..parallel import MeshTopology, set_mesh
from .config import DeeperSpeedConfig, _not_ported
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
    if mpu is not None and getattr(mpu, "get_pipe_parallel_world_size", lambda: 1)() > 1:
        raise _not_ported("an mpu with pipeline stages", "Pipelines")
    if hasattr(model, "stage_forward"):
        raise NotImplementedError(
            "pipeline modules are not ported yet (ROADMAP Queue A, 'Pipelines')")
    if int(os.environ.get("WORLD_SIZE", 1)) > 1 and dist_init_required is not False:
        comm.init_distributed(
            dist_backend="gloo" if str(device).startswith("cpu") else "nccl")
    if mesh is not None:
        mesh = set_mesh(MeshTopology(**mesh.sizes))
        if not isinstance(config, DeeperSpeedConfig):
            config = DeeperSpeedConfig(config, world_size=mesh.data_parallel_size)
    else:
        if not isinstance(config, DeeperSpeedConfig):
            config = DeeperSpeedConfig(config)
        mc = config.mesh_config
        set_mesh(MeshTopology(tp=mc.model_parallel_size, dp=mc.data_parallel_size,
                              zshard=config.zshard_size, ep=mc.expert_parallel_size))
    _apply_moe_quantized_alltoall(model, config)
    engine = DeeperSpeedEngine(
        model=model, config=config, optimizer=optimizer,
        model_parameters=model_parameters, loss_fn=loss_fn,
        training_data=training_data, collate_fn=collate_fn,
        lr_scheduler=lr_scheduler, device=device)
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
