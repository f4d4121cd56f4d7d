"""DeeperSpeed on PyTorch and CUDA: the port of ``deeperspeed_tpu`` to one
NVIDIA H100, slice by slice.

The JAX package stays the reference; this package imports neither JAX nor
anything of it.  Its first slice is paged GPT-NeoX serving
(``inference.v2.InferenceEngineV2``) on four hand-written Hopper kernels in
``csrc/``: LayerNorm forward, paged decode and speculative-decode
attention, and sorted top-k.  Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
