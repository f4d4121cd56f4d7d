"""DeeperSpeed on PyTorch and CUDA: the port of ``deeperspeed_tpu`` to one
NVIDIA H100, slice by slice.

The JAX package stays the reference; this package imports neither JAX nor
anything of it.  Two slices are ported, each on hand-written Hopper kernels
in ``csrc/``:

* serving: paged GPT-NeoX through ``inference.v2.InferenceEngineV2``, on
  the LayerNorm forward (K1), paged decode and speculative-decode attention
  (K2, K3) and sorted top-k (K4);
* training on one device (ZeRO-0): ``initialize(model=GPTNeoX(...),
  config=...)`` then ``engine.train_batch(batch=...)`` /
  ``engine.eval_batch(...)``, on flash attention forward (K5) and backward
  (K6 dk/dv, K7 dq) and the LayerNorm backward (K8) besides K1.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.2.0"

from .runtime.initialize import initialize  # noqa: E402,F401
