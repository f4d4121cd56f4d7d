"""DeeperSpeed on PyTorch and CUDA: the port of ``deeperspeed_tpu`` to one
NVIDIA H100, slice by slice.

The JAX package stays the reference; this package imports neither JAX nor
anything of it.  These paths are ported, each on hand-written Hopper kernels
in ``csrc/``:

* serving: paged GPT-NeoX and the Llama family (``models.Llama``: Llama-2,
  Mistral with grouped-query attention and a sliding window, OPT) through
  ``inference.v2.InferenceEngineV2`` and ``DSScheduler``, on the LayerNorm
  / RMSNorm forward (K1), paged decode and speculative-decode attention
  (K2, K3, with GQA's query groups folded into the batch) and sorted top-k
  (K4);
* the v1 engine: ``init_inference(model=..., config=...)`` then
  ``engine.generate(...)``, cached generation over a dense KV cache with
  int8 / int4 weight-only quantization and tensor parallelism;
* training: ``initialize(model=GPTNeoX(...) or Llama(...), config=...)`` then
  ``engine.train_batch(batch=...)`` / ``engine.eval_batch(...)``, on flash
  attention forward (K5) and backward (K6 dk/dv, K7 dq), the LayerNorm
  backward (K8) besides K1, and the fused optimizers (B6, B7); over several
  processes (``init_distributed``, ``torch.distributed``) laid out as the
  JAX mesh (``dp``, ``zshard``, ``ep``, ``tp``): ZeRO stages 0-3 with MiCS
  and hpZ, tensor parallelism, and the qgZ quantized gradient reduction,
  flat or two-hop, on the fused dequant-reduce (B5);
* Mixture-of-Experts (``moe``; GPT-NeoX with ``moe_num_experts`` > 1):
  top-1 / top-2 gating routed over the whole data-parallel batch, the
  stacked experts spread over ``ep`` and split over ``tp``, the quantized
  dispatch, checkpoints across ``ep`` degrees, served by both engines;
* offload (``zero_optimization.offload_optimizer``): the update on the host
  cores in a native CPU Adam (``csrc/host/``, built with ``g++``) over
  pinned host masters and moments, the optimizer state's pinned-host and
  NVMe tiers, and ZeRO-Infinity's chunk stream
  (``runtime.zero.infinity.ZeroInfinityEngine``);
* pipelines: ``initialize(model=GPTNeoXPipe(...) or LlamaPipe(...) or a
  PipelineModule, config=...)`` with ``mesh.pipe_parallel_size``, one
  process a stage, the 1F1B and GPipe schedules with point-to-point
  transfers over the ``pp`` group, pp x dp at ZeRO 0-2
  (``runtime.pipe``).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.2.0"

from .comm import init_distributed  # noqa: E402,F401
from .runtime.initialize import initialize  # noqa: E402,F401


def init_inference(model=None, config=None, device=None, **kwargs):
    """The v1 inference engine (reference ``deepspeed/__init__.py:269``):
    ``config`` a dict or ``inference.DeeperSpeedInferenceConfig``, keyword
    arguments as config keys; ``device`` CUDA unless ``device="cpu"``."""
    from .inference.config import DeeperSpeedInferenceConfig
    from .inference.engine import InferenceEngine

    if config is None:
        config = DeeperSpeedInferenceConfig(**kwargs)
    elif isinstance(config, dict):
        config = DeeperSpeedInferenceConfig(**{**config, **kwargs})
    return InferenceEngine(model=model, config=config, device=device)
