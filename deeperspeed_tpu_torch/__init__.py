"""DeeperSpeed on PyTorch and CUDA: the port of ``deeperspeed_tpu`` to one
NVIDIA H100, slice by slice.

The JAX package stays the reference; this package imports neither JAX nor
anything of it.  These paths are ported, each on hand-written Hopper kernels
in ``csrc/``:

* serving: paged GPT-NeoX through ``inference.v2.InferenceEngineV2``, on
  the LayerNorm forward (K1), paged decode and speculative-decode attention
  (K2, K3) and sorted top-k (K4);
* training: ``initialize(model=GPTNeoX(...), config=...)`` then
  ``engine.train_batch(batch=...)`` / ``engine.eval_batch(...)``, on flash
  attention forward (K5) and backward (K6 dk/dv, K7 dq), the LayerNorm
  backward (K8) besides K1, and the fused optimizers (B6, B7); over several
  processes (``init_distributed``, ``torch.distributed``) laid out as the
  JAX mesh (``dp``, ``zshard``, ``tp``): ZeRO stages 0-3 with MiCS and hpZ,
  tensor parallelism, and the qgZ quantized gradient reduction, flat or
  two-hop, on the fused dequant-reduce (B5).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.2.0"

from .comm import init_distributed  # noqa: E402,F401
from .runtime.initialize import initialize  # noqa: E402,F401
