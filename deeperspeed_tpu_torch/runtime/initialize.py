"""``initialize()`` -- the training entry point (counterpart of
``deeperspeed_tpu/runtime/initialize.py``).

Returns the reference's 4-tuple ``(engine, optimizer, dataloader,
lr_scheduler)``.  The single-device engine is the one ported; a pipeline
model, a mesh or an ``mpu`` raise ``NotImplementedError`` (the hybrid
engine's config block is refused by the config).
"""

from .engine import DeeperSpeedEngine
from ..utils.logging import log_dist


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None, mesh=None,
               loss_fn=None, config_params=None, device=None):
    """``device`` is CUDA unless the caller passes ``device="cpu"``."""
    if model is None:
        raise ValueError("deeperspeed_tpu_torch.initialize requires a model")
    if config is None:
        config = config_params
    if config is None and args is not None and hasattr(args, "deepspeed_config"):
        config = args.deepspeed_config
    if config is None:
        raise ValueError("no config: pass config= or args.deepspeed_config")
    if mesh is not None or mpu is not None:
        raise NotImplementedError(
            "mesh/mpu (several devices) is not ported yet (ROADMAP Queue A, "
            "'Multi-process training')")
    if hasattr(model, "stage_forward"):
        raise NotImplementedError(
            "pipeline modules are not ported yet (ROADMAP Queue A, 'Pipelines')")
    engine = DeeperSpeedEngine(
        model=model, config=config, optimizer=optimizer,
        model_parameters=model_parameters, loss_fn=loss_fn,
        training_data=training_data, collate_fn=collate_fn,
        lr_scheduler=lr_scheduler, device=device)
    log_dist("initialize() complete", ranks=[0])
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
